"""The port stands without jax, and its CUDA path never falls back to
the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sregex_tpu_torch.ops import _build
from sregex_tpu_torch.ops import spec_scan as tscan

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


ROOT = Path(__file__).resolve().parents[1]


def test_import_and_cpu_count_load_no_jax():
    code = (
        "import sys\n"
        "import sregex_tpu_torch\n"
        "sc = sregex_tpu_torch.compile_pattern('ab', device='cpu')\n"
        "sc.DEVICE_THRESHOLD = 1\n"
        "assert sc.count(b'xxab' * 3000) == 3000\n"
        "assert sc.stats().tier == 'SpecTablesPair', sc.stats()\n"
        "fs = sregex_tpu_torch.compile_pattern('(a+)(b+)', device='cpu')\n"
        "fs.DEVICE_THRESHOLD = 1\n"
        "assert fs.find(b'xx' * 1500 + b'aab') == (0, [3000, 3003, 3000, "
        "3002, 3002, 3003])\n"
        "assert fs.stats().tier == 'TdfaSpecTables', fs.stats()\n"
        "assert 'jax' not in sys.modules\n"
        "ref = [m for m in sys.modules\n"
        "       if m == 'sregex_tpu' or m.startswith('sregex_tpu.')]\n"
        "assert not ref, ref\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


SOURCES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "sregex_tpu_torch").rglob("*.py"),
              *(ROOT / "sregex_tpu_torch").rglob("*.cu"),
              *(ROOT / "sregex_tpu_torch").rglob("*.cpp"),
              ROOT / "chip_smoke.py"])


def _text(path):
    text = (ROOT / path).read_text()
    if path == "chip_smoke.py":
        # its kernel report names the TPU kernel each CUDA kernel
        # replaces, as file:line in the JAX package; nothing else may
        # name that package
        text = re.sub(r'"sregex_tpu/ops/\w+\.py:\d+"', '""', text)
    return text


@pytest.mark.parametrize("path", SOURCES)
def test_sources_never_import_jax_or_the_jax_ops(path):
    text = _text(path)
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"sregex_tpu\.ops|from\s+sregex_tpu\s+import\s+"
                         r"[^\n]*\bops\b", text)


@pytest.mark.parametrize("path", SOURCES)
def test_sources_never_name_the_jax_package_or_bench(path):
    text = _text(path)
    assert not re.search(r"\bsregex_tpu\b(?!_torch)", text)
    assert not re.search(r"^\s*(from|import)\s+bench\b", text, re.M)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import sregex_tpu_torch
    with pytest.raises(RuntimeError, match="cuda"):
        sregex_tpu_torch.compile_pattern("abc")
    prog = sregex_tpu_torch.compile_pattern("abc", device=None).program
    with pytest.raises(RuntimeError, match="cuda"):
        sregex_tpu_torch.Scanner(prog)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_cuda_scanner_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import sregex_tpu_torch
    with pytest.raises(RuntimeError, match="cuda"):
        sregex_tpu_torch.compile_pattern("abc", device="cuda")


def test_wrapper_never_falls_back_for_non_cpu_tensors():
    shape = (1, 1, 8, 128)
    data = torch.zeros((1, 20, 1, 8, 128), dtype=torch.int32,
                       device="meta")
    s = torch.zeros(shape, dtype=torch.int32, device="meta")
    table = torch.zeros(128, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tscan.spec_scan(data, s, s, table, W=32, CPW=8, BITS=4,
                        COUNT=True)


@pytest.mark.parametrize("bad", ["dtype", "shape", "table", "packing",
                                 "warmup", "devices"])
def test_wrapper_rejects_bad_arguments(bad):
    B, G, Jw = 1, 2, 20
    data = torch.zeros((B, Jw, G, 8, 128), dtype=torch.int32)
    s0 = torch.zeros((B, G, 8, 128), dtype=torch.int32)
    j0 = torch.zeros_like(s0)
    table = torch.zeros(128, dtype=torch.int32)
    kw = dict(W=32, CPW=8, BITS=4, COUNT=False)
    if bad == "dtype":
        data = data.to(torch.int64)
    elif bad == "shape":
        s0 = torch.zeros((B, G + 1, 8, 128), dtype=torch.int32)
    elif bad == "table":
        table = torch.zeros(100, dtype=torch.int32)
    elif bad == "packing":
        kw["CPW"] = 4
    elif bad == "warmup":
        kw["W"] = 36
    else:
        table = table.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tscan.spec_scan(data, s0, j0, table, **kw)
    before = tscan.spec_scan_launches
    ok = torch.zeros((B, G, 8, 128), dtype=torch.int32)
    tscan.spec_scan(torch.zeros((B, Jw, G, 8, 128), dtype=torch.int32),
                    ok, ok, torch.zeros(128, dtype=torch.int32),
                    W=32, CPW=8, BITS=4, COUNT=False)
    assert tscan.spec_scan_launches == before   # the plain version ran

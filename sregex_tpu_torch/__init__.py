"""sregex-tpu on PyTorch and CUDA: the engine's port to an NVIDIA Hopper
card, beside the JAX package it was ported from.

The package carries its own copy of the host frontend (parser,
compiler, DFA construction, the native C++ engine in
csrc/sre_host.cpp), so it imports neither jax nor the JAX package.
The device path is corpus prep in torch, the scan kernels in CUDA C++
(csrc/*.cu) each with a plain torch version beside it, the on-device
validation summary and the host folds with native repair.  find() adds
the tagged-DFA kernel (csrc/tdfa_scan.cu) and its host certification
fold, the reverse-DFA start locator and the Pike engines (pike_vm.py,
native_pike.py with csrc/sre_pike.cpp) that resolve captures.
finditer / sub / split add the native TDFA walker (native_tdfa.py with
csrc/sre_tdfa.cpp) and the reverse chunk-map index (make_index);
StreamScanner, StreamEditor, the Thompson VM, serialize and the CLI
(python -m sregex_tpu_torch.cli) complete the public surface, with the
Scanner's segmented-stream calls (*_stream) and its calls over a set of
documents in one kernel pass (*_many, ops/batch.py).
"""

from .ast_nodes import dump_str as dump_ast
from .bytecode import dump_program
from .compiler import compile_regex
from .consts import (SRE_AGAIN, SRE_BUSY, SRE_DECLINED, SRE_DONE,
                     SRE_ERROR, SRE_OK, SRE_REGEX_CASELESS,
                     SRE_REGEX_NEWLINE)
from .dfa import build_dfa
from .ops.spec_scan import spec_scan_last_bytes
from .ops.tdfa_scan import TdfaSpecTables, tdfa_spec_find
from .parser import ParseError, parse, parse_multi
from .pike_vm import PikeCtx, pike_create_ctx
from .serialize import load_compiled, save_compiled
from .stream import (PreparedCorpus, Scanner, StreamEditor, StreamScanner,
                     compile_pattern)
from .tdfa import Tdfa, TdfaTooLarge, tdfa_find
from .thompson_vm import ThompsonCtx, thompson_create_ctx

__all__ = ["SRE_OK", "SRE_ERROR", "SRE_AGAIN", "SRE_BUSY", "SRE_DONE",
           "SRE_DECLINED", "SRE_REGEX_CASELESS", "SRE_REGEX_NEWLINE",
           "parse", "parse_multi", "ParseError", "compile_regex",
           "PikeCtx", "pike_create_ctx", "ThompsonCtx",
           "thompson_create_ctx", "dump_ast", "dump_program",
           "compile_pattern", "Scanner", "StreamScanner", "StreamEditor",
           "PreparedCorpus", "save_compiled", "load_compiled",
           "build_dfa", "Tdfa", "TdfaTooLarge", "tdfa_find",
           "TdfaSpecTables", "tdfa_spec_find", "spec_scan_last_bytes"]

"""sregex-tpu on PyTorch and CUDA: the device half of sregex_tpu for an
NVIDIA Hopper card.

The host frontend (parser, compiler, DFA construction, the native C++
engines) is the JAX package's own, imported from sregex_tpu; none of
those modules imports jax.  What this package adds is the device path:
corpus prep in torch, the speculative scan kernel in CUDA C++
(csrc/spec_scan.cu) with a plain torch version beside it, the on-device
validation summary and the host folds with native repair.  It never
imports jax, nor the JAX package's device modules.
"""

from sregex_tpu.compiler import compile_regex
from sregex_tpu.dfa import build_dfa
from sregex_tpu.parser import ParseError, parse, parse_multi

from .stream import PreparedCorpus, Scanner, compile_pattern

__all__ = ["parse", "parse_multi", "ParseError", "compile_regex",
           "build_dfa", "Scanner", "compile_pattern", "PreparedCorpus"]

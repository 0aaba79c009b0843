"""sregex-tpu on PyTorch and CUDA: the engine's port to an NVIDIA Hopper
card, beside the JAX package it was ported from.

The package carries its own copy of the host frontend (parser,
compiler, DFA construction, the native C++ engine in
csrc/sre_host.cpp), so it imports neither jax nor the JAX package.
The device path is corpus prep in torch, the scan kernels in CUDA C++
(csrc/*.cu) each with a plain torch version beside it, the on-device
validation summary and the host folds with native repair.
"""

from .compiler import compile_regex
from .dfa import build_dfa
from .parser import ParseError, parse, parse_multi
from .stream import PreparedCorpus, Scanner, compile_pattern

__all__ = ["parse", "parse_multi", "ParseError", "compile_regex",
           "build_dfa", "Scanner", "compile_pattern", "PreparedCorpus"]

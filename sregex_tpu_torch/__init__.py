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
"""

from .compiler import compile_regex
from .dfa import build_dfa
from .ops.spec_scan import spec_scan_last_bytes
from .ops.tdfa_scan import TdfaSpecTables, tdfa_spec_find
from .parser import ParseError, parse, parse_multi
from .pike_vm import PikeCtx
from .stream import PreparedCorpus, Scanner, compile_pattern
from .tdfa import Tdfa, TdfaTooLarge, tdfa_find

__all__ = ["parse", "parse_multi", "ParseError", "compile_regex",
           "build_dfa", "Scanner", "compile_pattern", "PreparedCorpus",
           "PikeCtx", "Tdfa", "TdfaTooLarge", "tdfa_find",
           "TdfaSpecTables", "tdfa_spec_find", "spec_scan_last_bytes"]

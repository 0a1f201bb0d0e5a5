"""stringsearch_torch — the suffix-array and substring-search framework in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of stringsearch_tpu (JAX/Pallas on TPU), which stays beside it as
the reference. This package imports torch and numpy, never jax.

Layer map (mirrors stringsearch_tpu):

  engines/   SACA engines: doubling (+ the host oracle)
  ops/       device_sort: the Hopper bitonic kernel and its plain version
  oracle/    C++ host oracle (SA-IS + sufcheck/search), built by path
  harness/   corpus generators
  core/      SuffixArray, verify, search, compare

Host input goes to `device="cuda"` by default; a tensor stays on its own
device. Pass `device="cpu"` to run the plain PyTorch versions.
"""

from stringsearch_torch.core.types import (
    LongestCommonSubstring,
    NotSorted,
    SuffixArray,
    StringIndex,
)
from stringsearch_torch.core.verify import verify
from stringsearch_torch.core.compare import common_prefix_len
from stringsearch_torch.core.search import longest_substring_match, sa_search
from stringsearch_torch.engines import build_suffix_array, get_engine

__version__ = "0.1.0"

__all__ = [
    "LongestCommonSubstring",
    "NotSorted",
    "SuffixArray",
    "StringIndex",
    "verify",
    "common_prefix_len",
    "longest_substring_match",
    "sa_search",
    "build_suffix_array",
    "get_engine",
    "__version__",
]

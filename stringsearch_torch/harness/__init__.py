"""The port's harness: the CLI, the fuzzer, corpus generators, the span
recorder and the scripts that measure the kernels on one GPU, with what
those scripts share."""

import os
import re

# One H100's device memory rate (SXM, published): the bound each
# measurement script sets beside its times.
BYTES_PER_S = 3.35e12


def variant_source(name: str, source: str, edits) -> str:
    """Write a copy of the kernel source `source` with each (old, new)
    text of `edits` replaced, for a design sweep's `Library.variant`, to
    `_build/variants/`, named by `name` with "_" for what is not a word
    character, and return its path. Raises unless each old text occurs
    exactly once in the source."""
    from stringsearch_torch.ops._build import BUILD_DIR

    with open(source) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} does not occur "
                               f"exactly once in {source}")
        src = src.replace(old, new)
    path = os.path.join(BUILD_DIR, "variants",
                        re.sub(r"\W+", "_", name) + ".cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path

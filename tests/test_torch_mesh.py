"""Port of parallel/mesh.py against JAX.

Counterparts of the cases of tests/test_mesh.py: the mesh-sharded
partitioned index (`ShardedSuffixArray`, one partition per "parts" index,
needles split over "batch") against the full index and against the JAX
package's on its 8-device CPU mesh, at P = 2, 4 and 8 partitions of
`[cpu] * 8` devices. The JAX file's third case checks the entry points of
`__graft_entry__.py`, a file of the JAX package with no counterpart in the
port; its place is taken by the mesh contract: devices may repeat, the batch
axis divides the devices, and a mesh is never built on the CPU unless the
caller asks for it. Starts and lengths are integers: tolerance none.
"""

import jax
import numpy as np
import pytest
import torch

import stringsearch_torch as st
from stringsearch_torch.parallel import mesh as pmesh
from stringsearch_torch.parallel.mesh import (
    Mesh,
    ShardedSuffixArray,
    _pad_to_partitions,
    build_sharded,
    make_mesh,
)

CPU = torch.device("cpu")
PARTS = [2, 4, 8]


def _meshes(parts: int):
    """The port's and JAX's meshes of 8 devices with `parts` partitions."""
    from stringsearch_tpu.parallel.mesh import make_mesh as jmesh

    batch = 8 // parts
    return (make_mesh(8, batch_axis=batch, devices=[CPU] * 8),
            jmesh(8, batch_axis=batch, devices=jax.devices("cpu")))


@pytest.mark.parametrize("parts", PARTS)
def test_sharded_matches_full(parts):
    text = b"it is time, gentlemen; time to go home, time to sleep, time flies"
    mesh, jmesh = _meshes(parts)
    idx = ShardedSuffixArray(text, mesh)
    assert idx.num_partitions() == parts
    full = st.build_suffix_array(text, device="cpu")
    needles = [b"time to", b"gentle", b"sleep, time flies away", b"zzz", b"t"]
    res = idx.longest_substring_match_batch(needles)
    assert [m.len for m in res] == \
        [full.longest_substring_match(nd).len for nd in needles]
    for nd, m in zip(needles, res):
        assert text[m.start : m.start + m.len] == nd[: m.len]
    if parts == 4:
        from stringsearch_tpu.parallel.mesh import (
            ShardedSuffixArray as JSharded,
        )

        jres = JSharded(text, jmesh).longest_substring_match_batch(needles)
        assert [(m.start, m.len) for m in res] == \
            [(m.start, m.len) for m in jres]


@pytest.mark.parametrize("parts", PARTS)
def test_sharded_random(parts):
    rng = np.random.default_rng(21)
    text = bytes(rng.integers(0, 16, 777, dtype=np.uint8))
    mesh, _ = _meshes(parts)
    idx = ShardedSuffixArray(text, mesh)
    full = st.build_suffix_array(text, device="cpu")
    needles = [
        bytes(rng.integers(0, 16, int(rng.integers(1, 20)), dtype=np.uint8))
        for _ in range(11)  # an odd count pads the batch
    ]
    got = idx.longest_substring_match_batch(needles)
    want = full.longest_substring_match_batch(needles)
    for nd, g, w in zip(needles, got, want):
        assert g.len == w.len, nd
        assert text[g.start : g.start + g.len] == nd[: g.len]


@pytest.mark.parametrize("parts", PARTS)
def test_build_sharded_equals_jax(parts):
    """Every partition's SA, in its own coordinates, and the real lengths
    equal the JAX package's (all partitions of one device in one build)."""
    from stringsearch_tpu.parallel.mesh import build_sharded as jbuild

    text = bytes(np.random.default_rng(parts).integers(0, 4, 1001,
                                                       dtype=np.uint8))
    mesh, jmesh = _meshes(parts)
    chunks, sas, lens = build_sharded(text, mesh)
    jchunks, jsas, jlens = jbuild(text, jmesh)
    np.testing.assert_array_equal(torch.stack(chunks).numpy(),
                                  np.asarray(jchunks))
    np.testing.assert_array_equal(torch.stack(sas).numpy(), np.asarray(jsas))
    np.testing.assert_array_equal(lens, jlens)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100])
def test_pad_to_partitions_equals_jax(n):
    from stringsearch_tpu.parallel.mesh import _pad_to_partitions as jpad

    text = np.arange(n, dtype=np.uint8)
    padded, part, lens = _pad_to_partitions(torch.from_numpy(text), 4)
    jpadded, jpart, jlens = jpad(jax.numpy.asarray(text), 4)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    assert part == jpart
    np.testing.assert_array_equal(lens, jlens)


def test_mesh_contract(monkeypatch):
    """Devices may repeat; the grid is [parts][batch]; the batch axis must
    divide the devices; with no devices given the mesh is every visible
    CUDA device, and without one it refuses (no CPU mesh unasked)."""
    mesh = make_mesh(devices=["cpu"] * 6, batch_axis=3)
    assert mesh.shape == {"parts": 2, "batch": 3}
    assert mesh.axis_names == ("parts", "batch")
    assert mesh.part_devices == [CPU, CPU]
    assert make_mesh(2, devices=[CPU] * 8).shape["parts"] == 2
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(devices=[CPU] * 6, batch_axis=4)
    with pytest.raises(ValueError, match="rectangular"):
        Mesh([[CPU], [CPU, CPU]])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.make_mesh().part_devices == [torch.device("cuda", 0),
                                              torch.device("cuda", 1)]

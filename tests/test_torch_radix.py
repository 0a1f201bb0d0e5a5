"""Port of ops/radix.py: histograms, stable in-tile grouping, granule flush.

The port's plain versions (CPU tensors) are held against the reference's
Pallas kernels run in interpret mode, exactly as tests/test_radix.py runs
them, on the same numpy inputs; every output is an integer, so the
tolerance is 0. Keys are uint32 in the reference and their int32 bits in
the port. Tests that launch the Hopper kernels are marked `cuda` and skip
without a card; on a machine with one, run them with
`python -m pytest --noconftest -m cuda tests/test_torch_radix.py`
(this file imports jax only inside the tests that compare with it).
"""

import numpy as np
import pytest
import torch

from stringsearch_torch.ops import radix


def _bits(a: np.ndarray) -> torch.Tensor:
    """A uint32 (or int32) numpy array as an int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _random_keys(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint32)


def _two_bin_keys(seed: int, n: int, shift: int = 24) -> np.ndarray:
    """All keys in two bins (3 and 250) of the byte at `shift`, random bits
    elsewhere: long empty-bin runs in local_base."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    mask = np.uint32(~(0xFF << shift) & 0xFFFFFFFF)
    top = rng.choice(np.asarray([3, 250], np.uint32), n)
    return (keys & mask) | (top << np.uint32(shift))


def _one_bin_keys(seed: int, n: int, shift: int = 24) -> np.ndarray:
    """Every key in bin 7: ranks inside the bin reach tile - 1."""
    keys = _random_keys(seed, n)
    mask = np.uint32(~(0xFF << shift) & 0xFFFFFFFF)
    return (keys & mask) | (np.uint32(7) << np.uint32(shift))


def _all_equal_keys(seed: int, n: int, shift: int = 24) -> np.ndarray:
    """One 32-bit pattern everywhere."""
    return np.full(n, 0xDEADBEEF, dtype=np.uint32)


_KEY_SETS = {"random": _random_keys, "two bins": _two_bin_keys,
             "one bin": _one_bin_keys, "all equal": _all_equal_keys}


def _ref():
    from stringsearch_tpu.ops import radix as ref

    return ref


def _keys_of(kind: str, seed: int, n: int, shift: int) -> torch.Tensor:
    if kind == "random":
        return _bits(_random_keys(seed, n))
    return _bits(_KEY_SETS[kind](seed, n, shift))


def _valid_warps(tile: int) -> list:
    """The warps per tile the destination kernel takes for `tile`: powers
    of two up to 32 that leave a lane at most 32 keys."""
    return [w for w in (1, 2, 4, 8, 16, 32) if -(-(-(-tile // 32)) // w) <= 32]


_STEP_TILES = (1, 32, 100, 1000, 1024, 2048, 8192)
# the rule's own choice, every other valid one of 1/2/4/8, and a whole block
_TILE_WARPS = [(t, w) for t in _STEP_TILES for w in _valid_warps(t)
               if w in (1, 2, 4, 8, 32) or w == min(_valid_warps(t))]


# ---------------------------------------------------------------------------
# plain versions against the reference in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,tile,shift", [
    (8 * 1024, 1024, 24), (8 * 1024, 1024, 0), (8 * 1024, 1024, 28),
    (8 * 8192, 8192, 24)])
def test_block_histograms_equal_reference(n, tile, shift):
    import jax.numpy as jnp

    keys = _random_keys(n + shift, n)
    want = np.asarray(_ref().block_histograms(
        jnp.asarray(keys), tile=tile, shift=shift, interpret=True))
    got = radix.block_histograms(_bits(keys), tile=tile, shift=shift)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert radix.check_histogram(_bits(keys), tile=tile, shift=shift)


@pytest.mark.parametrize("tile,keys", [
    (1024, "random"), (1024, "two bins"), (2048, "random")])
def test_local_group_equal_reference(tile, keys):
    import jax.numpy as jnp

    n = 8 * 1024
    k = {"random": _random_keys(9, n), "two bins": _two_bin_keys(10, n)}[keys]
    pay = np.random.default_rng(11).integers(0, 1 << 31, n, dtype=np.int32)
    wk, wp, wl = (np.asarray(x) for x in _ref().local_group(
        jnp.asarray(k), jnp.asarray(pay), tile=tile, interpret=True))
    gk, gp, gl = radix.local_group(_bits(k), torch.from_numpy(pay), tile=tile)
    np.testing.assert_array_equal(gk.numpy().view(np.uint32), wk)
    np.testing.assert_array_equal(gp.numpy(), wp)
    np.testing.assert_array_equal(gl.numpy(), wl)
    assert radix.check_local_group(_bits(k), torch.from_numpy(pay), tile=tile)


@pytest.mark.parametrize("total,granule,per_block",
                         [(2048, 128, 1024), (1024, 1024, 1024)])
def test_granule_flush_equal_reference(total, granule, per_block):
    import jax.numpy as jnp

    rng = np.random.default_rng(total + granule)
    desc = rng.permutation(total).astype(np.int32)
    src = rng.integers(0, 1 << 30, (total, granule), dtype=np.int32)
    want = np.asarray(_ref().granule_flush(
        jnp.asarray(desc), jnp.asarray(src), granule, per_block, total,
        interpret=True))
    got = radix.granule_flush(torch.from_numpy(desc), torch.from_numpy(src),
                              granule, per_block, total)
    np.testing.assert_array_equal(got.numpy(), want)
    assert radix.check_granule_flush(total, granule, per_block, device="cpu")


def test_granule_flush_wider_output_equal_reference_on_written_rows():
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    total, granule, out_rows = 1024, 128, 1536
    desc = rng.choice(out_rows, total, replace=False).astype(np.int32)
    src = rng.integers(0, 1 << 30, (total, granule), dtype=np.int32)
    want = np.asarray(_ref().granule_flush(
        jnp.asarray(desc), jnp.asarray(src), granule, total, out_rows,
        interpret=True))
    got = radix.granule_flush(torch.from_numpy(desc),
                              torch.from_numpy(src.reshape(-1)), granule,
                              total, out_rows)
    assert got.shape == (out_rows, granule)
    np.testing.assert_array_equal(got.numpy()[desc], want[desc])
    np.testing.assert_array_equal(got.numpy()[desc], src)


# ---------------------------------------------------------------------------
# plain versions on their own
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [0, 8, 16, 24, 25, 31])
def test_bins_are_the_unsigned_byte(shift):
    keys = np.asarray([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF,
                       0x12345678], dtype=np.uint32)
    want = (keys >> np.uint32(shift)) & np.uint32(0xFF)
    np.testing.assert_array_equal(radix._bins(_bits(keys), shift).numpy(),
                                  want.astype(np.int32))


@pytest.mark.parametrize("tile", [1, 32, 100, 1024])
def test_plain_dest_is_a_stable_tile_local_permutation(tile):
    n = 4 * tile
    keys = _bits(_two_bin_keys(tile, n, shift=8))
    dest, local_base = radix.plain_dest(keys, tile, 8)
    d = dest.numpy().reshape(-1, tile)
    assert (np.sort(d, axis=1) == np.arange(tile)).all()
    assert radix.check_local_group(keys, torch.arange(n, dtype=torch.int32),
                                   tile=tile, shift=8)
    np.testing.assert_array_equal(local_base[:, 0].numpy(), 0)


@pytest.mark.parametrize("shift", [0, 8, 24, 25, 31])
@pytest.mark.parametrize("kind", ["all equal", "one bin", "random",
                                  "two bins"])
@pytest.mark.parametrize("tile,warps", _TILE_WARPS)
def test_plain_dest_steps_equal_plain_dest(tile, warps, kind, shift):
    """The destination kernel's steps (warp runs, 32-key segments, counters
    per warp, scans over warps and bins) give `plain_dest` exactly."""
    n = 3 * tile
    keys = _keys_of(kind, tile + warps + shift, n, shift)
    dest, local_base = radix.plain_dest_steps(keys, tile, shift, warps)
    want_dest, want_lb = radix.plain_dest(keys, tile, shift)
    assert dest.dtype == torch.int32 and local_base.dtype == torch.int32
    assert torch.equal(dest, want_dest)
    assert torch.equal(local_base, want_lb)


@pytest.mark.parametrize("tile,keys", [
    (1024, "random"), (1024, "two bins"), (2048, "random"),
    (2048, "two bins")])
def test_plain_dest_steps_equal_reference(tile, keys):
    """The steps against the reference's `local_group` in interpret mode:
    its local_base, and its grouped keys and payloads once `plain_place`
    has applied the destinations. Tolerance 0."""
    import jax.numpy as jnp

    n = 8 * 1024
    k = {"random": _random_keys(17, n), "two bins": _two_bin_keys(18, n)}[keys]
    pay = np.random.default_rng(19).integers(0, 1 << 31, n, dtype=np.int32)
    wk, wp, wl = (np.asarray(x) for x in _ref().local_group(
        jnp.asarray(k), jnp.asarray(pay), tile=tile, interpret=True))
    warps = radix.dest_warps_per_tile(tile)
    dest, local_base = radix.plain_dest_steps(_bits(k), tile, 24, warps)
    gk, gp = radix.plain_place(_bits(k), torch.from_numpy(pay), dest, tile)
    np.testing.assert_array_equal(local_base.numpy(), wl)
    np.testing.assert_array_equal(gk.numpy().view(np.uint32), wk)
    np.testing.assert_array_equal(gp.numpy(), wp)


@pytest.mark.parametrize("tile,warps", [
    (1, 1), (100, 1), (1024, 1), (1025, 2), (2048, 2), (2049, 4), (4096, 4),
    (8192, 8), (8193, 16), (16384, 16), (29056, 32), (32768, 32)])
def test_dest_warps_per_tile_is_the_fewest_that_fit(tile, warps):
    assert radix.dest_warps_per_tile(tile) == warps
    assert warps == min(_valid_warps(tile))
    assert radix._check_dest_warps(tile, warps) <= 32


@pytest.mark.parametrize("tile,warps", [(2048, 1), (8192, 4), (32800, 32),
                                        (1024, 3), (1024, 0), (1024, 64)])
def test_plain_dest_steps_reject_warps_the_kernel_does_not_take(tile, warps):
    with pytest.raises(ValueError, match="warps|keys"):
        radix.plain_dest_steps(torch.zeros(tile, dtype=torch.int32), tile, 24,
                               warps)


DEST_VARIANTS = ["dest match_any", "dest vote or its complement by the bit",
                 "dest tests every segment of the loop",
                 "dest block of 4 warps", "dest block of 16 warps",
                 "dest resident 512 threads", "dest resident 1024 threads",
                 "dest resident 1536 threads", "dest resident 2048 threads",
                 "dest half the warps 64 keys a lane",
                 "dest twice the warps 16 keys a lane", "dest twice the warps",
                 "dest four times the warps"]


@pytest.mark.parametrize("name", DEST_VARIANTS)
def test_dest_variants_each_change_the_source_once(name):
    """The design sweep patches the destination kernel's source by text, or
    gives a tile other warps; each patch must still find its one place, and
    every warp count must be one the kernel takes."""
    from stringsearch_torch.harness import sort_variants

    assert set(DEST_VARIANTS) | {"dest as built"} == set(
        sort_variants.DEST_VARIANTS)
    edits, warps = sort_variants.DEST_VARIANTS[name]
    assert edits or warps
    with open(radix._SOURCE) as f:
        built = f.read()
    with open(sort_variants.variant_source(name)) as f:
        variant = f.read()
    assert (variant != built) == bool(edits)
    assert len(variant.splitlines()) == len(built.splitlines())
    per_lane = {"64": 64, "16": 16}.get(name.split(" keys a lane")[0][-2:],
                                         32)
    for tile, w in warps.items():
        assert tile in sort_variants._DEST_TILES
        assert w in (1, 2, 4, 8, 16, 32)
        assert -(-(tile // 32) // w) <= per_lane


def test_one_bin_keys_keep_their_order():
    n, tile = 4 * 1024, 1024
    keys = _bits(_one_bin_keys(13, n))
    pay = torch.arange(n, dtype=torch.int32)
    gk, gp, lb = radix.local_group(keys, pay, tile=tile)
    assert torch.equal(gk, keys) and torch.equal(gp, pay)
    assert (lb[:, :8] == 0).all() and (lb[:, 8:] == tile).all()


def test_public_functions_take_plain_versions_on_cpu():
    keys = _bits(_random_keys(14, 2048))
    pay = torch.arange(2048, dtype=torch.int32)
    before = dict(radix.launches)
    radix.block_histograms(keys, tile=1024)
    radix.local_group(keys, pay, tile=1024)
    radix.granule_flush(torch.arange(16, dtype=torch.int32), pay, 128, 16, 16)
    assert radix.launches == before


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_histograms_reject_bad_tiling():
    keys = torch.zeros(8192, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of tile"):
        radix.block_histograms(keys, tile=3000, chunk=1000)
    # the reference counts 6000 of every 8192 keys here; the port raises
    with pytest.raises(ValueError, match="multiple of chunk"):
        radix.block_histograms(keys, tile=8192, chunk=3000)
    with pytest.raises(ValueError, match="shift"):
        radix.block_histograms(keys, tile=8192, shift=32)
    with pytest.raises(TypeError, match="int32"):
        radix.block_histograms(keys.to(torch.int64), tile=8192)


def test_local_group_rejects_bad_tiling():
    keys = torch.zeros(2048, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of tile"):
        radix.local_group(keys, keys, tile=1000, chunk=100)
    with pytest.raises(ValueError, match="multiple of chunk"):
        radix.local_group(keys, keys, tile=1024, chunk=300)
    with pytest.raises(ValueError, match="one shape"):
        radix.local_group(keys, keys[:1024], tile=1024)
    with pytest.raises(TypeError, match="int32"):
        radix.local_group(keys, keys.to(torch.int64), tile=1024)


def test_granule_flush_rejects_bad_arguments():
    desc = torch.arange(12, dtype=torch.int32)
    src = torch.zeros((12, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="per_block"):
        radix.granule_flush(desc, src, 4, 5, 12)
    with pytest.raises(ValueError, match="values"):
        radix.granule_flush(desc, src, 8, 4, 12)
    with pytest.raises(ValueError, match=">= 1"):
        radix.granule_flush(desc, src, 4, 0, 12)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run the plain versions in their place."""
    keys = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        radix.kernel_histograms(keys, 1024, 24)
    with pytest.raises(ValueError, match="CUDA"):
        radix.kernel_dest(keys, 1024, 24)
    with pytest.raises(ValueError, match="CUDA"):
        radix.kernel_place(keys, keys, keys, 1024)
    with pytest.raises(ValueError, match="CUDA"):
        radix.kernel_granule_flush(keys[:8], keys.reshape(8, 128), 8)


# ---------------------------------------------------------------------------
# Hopper kernels against their plain versions (need a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")




@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 8, 16, 24])
@pytest.mark.parametrize("tile,tiles", [(8192, 8), (1024, 64), (1000, 3)])
@pytest.mark.parametrize("kind", ["one bin", "random", "two bins"])
def test_hist_kernel_matches_plain(cuda, kind, tile, tiles, shift):
    n = tile * tiles
    keys = _keys_of(kind, n + shift, n, shift)
    before = radix.launches["hist"]
    got = radix.block_histograms(keys.to(cuda), tile=tile, chunk=tile,
                                 shift=shift)
    torch.cuda.synchronize()
    assert radix.launches["hist"] == before + 1
    assert torch.equal(got.cpu(), radix.plain_histograms(keys, tile, shift))
    assert (got.sum(1) == tile).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 8, 16, 24, 25, 31])
@pytest.mark.parametrize("tile,tiles", [
    (1024, 16), (2048, 8), (100, 5), ("max", 2), (1, 7), (32, 5), (1000, 3),
    (8192, 3),
    # tile counts that leave the last block of 8 warps part empty
    (1024, 13), (2048, 7), (100, 17)])
@pytest.mark.parametrize("kind", ["all equal", "one bin", "random",
                                  "two bins"])
def test_dest_and_place_kernels_match_plain(cuda, kind, tile, tiles, shift):
    if tile == "max":  # the largest tile both grouping kernels take
        tile = min(radix.max_tiles().values())
    n = tile * tiles
    keys = _keys_of(kind, n + shift, n, shift)
    pay = torch.from_numpy(
        np.random.default_rng(n).integers(-(1 << 31), 1 << 31, n,
                                          dtype=np.int32))
    want_dest, want_lb = radix.plain_dest(keys, tile, shift)
    before = dict(radix.launches)
    dest, lb = radix.kernel_dest(keys.to(cuda), tile, shift)
    gk, gp = radix.kernel_place(keys.to(cuda), pay.to(cuda), dest, tile)
    torch.cuda.synchronize()
    assert radix.launches["dest"] == before["dest"] + 1
    assert radix.launches["place"] == before["place"] + 1
    assert torch.equal(dest.cpu(), want_dest)
    assert torch.equal(lb.cpu(), want_lb)
    wk, wp = radix.plain_place(keys, pay, want_dest, tile)
    assert torch.equal(gk.cpu(), wk) and torch.equal(gp.cpu(), wp)
    assert radix.check_local_group(keys.to(cuda), pay.to(cuda), tile=tile,
                                   shift=shift)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one bin", "random", "two bins"])
@pytest.mark.parametrize("tile,tiles", [
    (32768, 2), (32767, 3), (16384, 3), (8193, 2), (5000, 5), (2049, 9),
    (1025, 11), (33, 70)])
def test_dest_kernel_matches_plain_and_its_steps(cuda, kind, tile, tiles):
    """Tiles up to the destination kernel's own limit, most of them ending
    in a partial segment, against `plain_dest` and `plain_dest_steps`."""
    assert tile <= radix.max_tiles()["dest"] == 32 * 32 * 32
    n = tile * tiles
    keys = _keys_of(kind, n, n, 24).to(cuda)
    before = radix.launches["dest"]
    dest, lb = radix.kernel_dest(keys, tile, 24)
    torch.cuda.synchronize()
    assert radix.launches["dest"] == before + 1
    for want in (radix.plain_dest(keys, tile, 24),
                 radix.plain_dest_steps(keys, tile, 24,
                                        radix.dest_warps_per_tile(tile))):
        assert torch.equal(dest, want[0]) and torch.equal(lb, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("tile,warps", _TILE_WARPS)
def test_dest_kernel_on_every_warp_count_it_takes(cuda, tile, warps):
    """The library's entry with the warps per tile given: ranks stay in
    tile order however many warps share the tile (13 tiles, so the last
    block is part empty). It refuses a count that leaves a lane too many
    keys, and one that is no power of two."""
    n = 13 * tile
    keys = _bits(_two_bin_keys(tile + warps, n)).to(cuda)

    def launch(w):
        dest = torch.empty_like(keys)
        lb = torch.empty((13, 256), dtype=torch.int32, device=cuda)
        radix.LIBRARY.call("ss_radix_dest", keys.device, keys.data_ptr(), n,
                           tile, 24, w, dest.data_ptr(), lb.data_ptr())
        torch.cuda.synchronize()
        return dest, lb

    dest, lb = launch(warps)
    want_dest, want_lb = radix.plain_dest(keys, tile, 24)
    assert torch.equal(dest, want_dest) and torch.equal(lb, want_lb)
    for bad in (3, 64, min(_valid_warps(tile)) // 2):
        with pytest.raises(RuntimeError, match="invalid"):
            launch(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("granule", [1, 3, 128, 1024, 4096])
@pytest.mark.parametrize("order", ["random", "sequential"])
def test_flush_kernel_matches_plain(cuda, granule, order):
    rows = max(64, (1 << 20) // granule)
    rng = np.random.default_rng(granule)
    desc = (rng.permutation(rows) if order == "random"
            else np.arange(rows)).astype(np.int32)
    src = rng.integers(-(1 << 31), 1 << 31, (rows, granule), dtype=np.int32)
    d, s = torch.from_numpy(desc), torch.from_numpy(src)
    before = radix.launches["flush"]
    got = radix.granule_flush(d.to(cuda), s.to(cuda), granule, rows, rows)
    torch.cuda.synchronize()
    assert radix.launches["flush"] == before + 1
    assert torch.equal(got.cpu(), radix.plain_granule_flush(d, s, rows))


@pytest.mark.cuda
def test_flush_kernel_unaligned_rows_and_wider_output(cuda):
    rows, granule, out_rows = 1000, 128, 1500
    rng = np.random.default_rng(15)
    desc = rng.choice(out_rows, rows, replace=False).astype(np.int32)
    flat = torch.from_numpy(
        rng.integers(0, 1 << 30, rows * granule + 1, dtype=np.int32))
    src = flat[1:].reshape(rows, granule)  # starts 4 bytes into its storage
    got = radix.kernel_granule_flush(torch.from_numpy(desc).to(cuda),
                                     src.to(cuda), out_rows)
    got_view = radix.kernel_granule_flush(
        torch.from_numpy(desc).to(cuda), flat.to(cuda)[1:].view(rows, granule),
        out_rows)
    for g in (got, got_view):
        assert torch.equal(g.cpu()[torch.from_numpy(desc).long()], src)


@pytest.mark.cuda
def test_check_functions_pass_on_the_card(cuda):
    keys = _bits(_random_keys(16, 8 * 8192)).to(cuda)
    pay = torch.arange(8 * 8192, dtype=torch.int32, device=cuda)
    assert radix.check_histogram(keys, tile=8192)
    assert radix.check_local_group(keys[:8 * 1024], pay[:8 * 1024], tile=1024)
    assert radix.check_granule_flush(device=cuda)


@pytest.mark.cuda
def test_kernels_reject_other_dtypes_and_big_tiles(cuda):
    k64 = torch.zeros(2048, dtype=torch.int64, device=cuda)
    limits = radix.max_tiles()
    assert limits["dest"] >= limits["place"] >= 2048
    k32 = torch.zeros(2 * limits["dest"] + 64, dtype=torch.int32,
                      device=cuda)
    with pytest.raises(TypeError):
        radix.block_histograms(k64, tile=1024, chunk=1024)
    with pytest.raises(TypeError):
        radix.local_group(k64, k64, tile=1024)
    with pytest.raises(TypeError):
        radix.kernel_granule_flush(k64[:16].to(torch.int32),
                                   k64.reshape(16, 128), 16)
    with pytest.raises(TypeError):
        radix.kernel_histograms(k32.to(torch.uint8), 1, 24)
    big = limits["dest"] + 32
    with pytest.raises(ValueError, match="at most"):
        radix.local_group(k32[:2 * big], k32[:2 * big], tile=big, chunk=big)
    with pytest.raises(ValueError, match="at most"):
        radix.kernel_dest(k32[:2 * big], big, 24)
    # between the two limits the placement kernel refuses
    between = limits["place"] + 32
    if between <= limits["dest"]:
        radix.kernel_dest(k32[:2 * between], between, 24)
        with pytest.raises(ValueError, match="placement"):
            radix.local_group(k32[:2 * between], k32[:2 * between],
                              tile=between, chunk=between)

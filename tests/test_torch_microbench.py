"""Port of harness/microbench.py, at tiny sizes on the CPU.

The profilers' round structure (tied counts per round, rounds per level)
must equal the JAX functions' on the same enwik-like text; times are the
host's here and are not compared. The radix probe runs the port's plain
versions and its checks.
"""

import json

import pytest

from stringsearch_torch.harness import microbench

# the keys of the reference's radix_probe result (stringsearch_tpu/harness/
# microbench.py, radix_probe)
RADIX_KEYS = {"n", "t_sort_1key_2op", "checks", "t_hist", "t_group",
              "t_flush", "pass8_est"}


def _jax_microbench():
    from stringsearch_tpu.harness import microbench as ref

    return ref


def test_radix_probe_keys_and_checks():
    out = microbench.radix_probe(16, reps=1, device="cpu")
    assert RADIX_KEYS <= set(out)
    assert out["device"] == "cpu"
    assert out["checks"] == {"hist": True, "group": True, "flush": True}
    assert set(out["t_group"]) == {1024, 2048}
    assert set(out["t_flush"]) == {128, 1024, 4096}
    assert [f["per_block"] for f in out["t_flush"].values()] == [512, 64, 16]
    assert set(out["pass8_est"]) == {f"T{t}_G{g}" for t in (1024, 2048)
                                     for g in (128, 1024, 4096)}
    assert out["pass8_est"]["T1024_G128"]["pad_factor"] == 32.0


@pytest.mark.parametrize("depth,fan", [(12, 4), (4, 2)])
def test_phase_profile_rounds_equal_jax(depth, fan):
    got = microbench.phase_profile(12, reps=1, depth=depth, fan=fan,
                                   device="cpu")
    want = _jax_microbench().phase_profile(12, reps=1, depth=depth, fan=fan)
    for key in ("n", "tied_counts", "full_rounds", "l1_rounds", "l2_rounds",
                "compact_tied_counts"):
        assert got.get(key) == want.get(key), key
    assert set(want) <= set(got)


@pytest.mark.parametrize("depth", [12, 4])
def test_tied_curve_rounds_equal_jax(depth):
    got = microbench.tied_curve(12, depth=depth, reps=1, device="cpu")
    want = _jax_microbench().tied_curve(12, depth=depth, reps=1)
    assert [(r["h"], r["tied"], r["frac"]) for r in got["rounds"]] == [
        (r["h"], r["tied"], r["frac"]) for r in want["rounds"]]
    assert len(got["rounds"]) > 1


@pytest.fixture
def one_thread():
    """The walk probe is thousands of tiny indexing calls: on several
    threads each call pays for waking them, many times over when other test
    processes share the cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_main_rejects_walk(capsys, one_thread):
    """`walk` was rejected until the BWT was ported. Now `main` runs it,
    and still rejects a mode it does not have."""
    microbench.main(["walk", "--n", "10", "--reps", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n"] == 1024 and out["device"] == "cpu"
    assert not hasattr(microbench, "WALK_REJECTED")
    with pytest.raises(SystemExit) as e:
        microbench.main(["stroll"])
    assert e.value.code == 2


def test_walk_probe_keys_equal_jax(one_thread):
    got = microbench.walk_probe(12, reps=1, device="cpu")
    want = _jax_microbench().walk_probe(12, reps=1)
    assert set(want) <= set(got)
    assert got["n"] == want["n"] == 4096
    assert got["steps_measured"] == want["steps_measured"] == 2048
    assert got["rounds"] == 13
    assert set(got["walkers"]) == set(want["walkers"]) == {1024, 4096, 16384}
    for b, row in got["walkers"].items():
        assert set(row) == set(want["walkers"][b])
        assert all(v > 0 for v in row.values())
    assert got["t_pointer_jumping"] > 0
    assert set(got["t_jump_round"]) == {
        "row8_index_select_int32", "rows_advanced_index", "two_planes"}


def test_jump_round_formulations_agree():
    """The shipped pointer-jumping round (one 8-byte `index_select`)
    against the reference's formulation, a row gather of the [m, 2]
    state."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from stringsearch_torch.transforms.bwt import _jump

    rng = np.random.default_rng(12)
    state = np.stack([rng.permutation(1001).astype(np.int32),
                      rng.integers(0, 9, 1001, dtype=np.int32)], 1)
    st = jnp.asarray(state)
    g = jnp.take(st, st[:, 0], axis=0)
    want = jnp.stack([g[:, 0], st[:, 1] + g[:, 1]], axis=1)
    got = _jump(torch.from_numpy(state))
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def kernel_shaped_sorts(monkeypatch):
    """Let every sort a mode times through `device_sort` be one that the
    CUDA kernel takes: 1..6 one-dimensional int32 planes. On the CPU the
    plain sort would take any."""
    import torch

    from stringsearch_torch.engines import doubling
    from stringsearch_torch.ops import bitonic

    def checked(operands, num_keys=1):
        operands = tuple(operands)
        assert 1 <= len(operands) <= bitonic._MAX_PLANES
        assert all(op.dtype == torch.int32 and op.dim() == 1
                   for op in operands)
        return bitonic.plain_sort(operands, num_keys)

    monkeypatch.setattr(microbench, "device_sort", checked)
    monkeypatch.setattr(doubling, "device_sort", checked)


@pytest.mark.usefixtures("kernel_shaped_sorts")
@pytest.mark.parametrize("argv,keys", [
    (["ops", "--n", "12"], {"log_n", "dispatch_floor", "sort_4key_5op",
                            "sort_6key_7op_plain", "topk_n4",
                            "slice_gather_rows4096", "cumsum",
                            "sort_1key_2op_f32_bitcast_plain"}),
    (["ops", "--n", "16"], {"batched_sort_1key_2op_rows4096",
                            "batched_sort_5key_6op_rows4096"}),
    (["phases", "--n", "12", "--depth", "4"], {"tied_counts", "l2_rounds"}),
    (["tiedcurve", "--n", "12"], {"rounds", "t_initial"}),
    (["extract", "--n", "12"], {"tied", "sort_m_n4", "topk_m_n64"}),
    (["bucketed", "--n", "12"], {"flat_3key", "carry_rows", "gather_rows"}),
    (["sweep", "--n", "12", "--configs",
      '[{"fn": "sa", "depth": 12, "fan": 4}, {"fn": "isa", "depth": 8}]'],
     {"configs"}),
    (["radix", "--n", "16"], RADIX_KEYS),
])
def test_main_modes_on_cpu(capsys, argv, keys):
    microbench.main(argv + ["--reps", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert keys <= set(out)
    if argv[0] == "sweep":
        assert [c["fn"] for c in out["configs"]] == ["build_sa",
                                                     "build_with_isa"]
        assert all(c["wall_s"] > 0 for c in out["configs"])


def test_op_table_rows_match_jax():
    """Row for row the reference's op table: each row under its own name,
    or with `_plain` appended where the kernel does not take the sort. The
    reference's `sort_1key_2op_i64` row exists only under jax_enable_x64,
    off here."""
    got = microbench.op_costs(8, reps=1, device="cpu")
    want = _jax_microbench().op_costs(8, reps=1)
    assert "sort_1key_2op_i64" not in want
    assert {k.removesuffix("_plain") for k in got} == set(want)
    assert {k for k in got if k.endswith("_plain")} == {
        "sort_6key_7op_plain", "sort_1key_2op_f32_bitcast_plain"}
    assert all(v >= 0 for v in got.values())


def test_bucketed_row_sort_equals_jax_batched_sort():
    """The port's batched sort along dim 1 against lax.sort(dimension=1)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    ops = [rng.integers(0, 4, (8, 64), dtype=np.int32) for _ in range(3)]
    ops.append(np.broadcast_to(np.arange(64, dtype=np.int32), (8, 64)).copy())
    want = jax.lax.sort(tuple(jnp.asarray(a) for a in ops), num_keys=3,
                        dimension=1)
    got = microbench._row_sort(tuple(torch.from_numpy(a) for a in ops), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

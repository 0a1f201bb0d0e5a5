"""Port of harness/scaling.py.

The JAX harness times builds on its virtual CPU mesh; the port's takes a
device list, which may repeat a device. On the CPU here: `measure` in both
modes at 1, 2 and 4 shards of `[cpu] * 4` (times are the host's and are
not checked, only the rows' shape and the comm reports), its comm reports
equal to the JAX model's arithmetic, the table's note that shards sharing
a device are no scaling result, the projection only with `--link-gbps`,
and return code 2 without a GPU unless `--device cpu` is given.
"""

import pytest
import torch

from stringsearch_torch.harness import scaling
from stringsearch_torch.parallel.comm_model import global_build_comm

CPU = torch.device("cpu")


@pytest.mark.parametrize("mode", ["global", "partitioned"])
def test_measure_rows(mode):
    size = 3000
    rows = scaling.measure(size, reps=1, devices=[CPU] * 4, mode=mode)
    assert [r[0] for r in rows] == [1, 2, 4]
    for k, dt, bps, report, ndev in rows:
        assert dt > 0 and bps == pytest.approx(size / dt)
        assert ndev == 1
        if mode == "global":
            assert report.p == k and report.rounds >= 0
            assert report == global_build_comm(size, k, rounds=report.rounds)
        else:
            assert report is None


def test_main_prints_bytes_and_no_projection_without_a_rate(capsys):
    assert scaling.main(["8k", "--device", "cpu", "--shards", "4",
                         "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert "mode: global; device: cpu" in out
    lines = out.splitlines()
    table = lines[2:5]
    assert [line.split()[0] for line in table] == ["1", "2", "4"]
    assert "not a scaling result" not in table[0]
    assert "4 shards share 1 device: not a scaling result" in table[2]
    assert "comm model (bytes each shard sends):" in out
    assert "Wire time" not in out and "Proj. eff." not in out


def test_main_projects_at_the_given_link_rate(capsys):
    assert scaling.main(["8k", "--device", "cpu", "--shards", "2",
                         "--reps", "1", "--link-gbps", "50"]) == 0
    out = capsys.readouterr().out
    assert "projected at 50 GB/s" in out
    assert "Wire time" in out and "Proj. eff." in out


def test_main_partitioned_mode(capsys):
    assert scaling.main(["4k", "--device", "cpu", "--shards", "2",
                         "--reps", "1", "--mode", "partitioned"]) == 0
    out = capsys.readouterr().out
    assert "mode: partitioned" in out and "comm model" not in out


def test_main_without_a_card_returns_2(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert scaling.main(["4k"]) == 2
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and captured.out == ""


def test_measure_refuses_to_pick_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.measure(1000, reps=1)

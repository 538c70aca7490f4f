"""chip_smoke.py on the CPU: the device check refuses to run, and every
phase function runs end to end at a tiny size (the fused kernel in the
Pallas interpreter), so the first run on the card only has to compile."""

import dataclasses
import json

import numpy as np
import pytest

import chip_smoke
from graphik_tpu.solvers.local import LocalParams
from graphik_tpu.solvers.riemannian import TRParams

TINY = TRParams.production(maxiter=3, maxinner=4)
POLISH = LocalParams(maxiter=2, tol_grad=1e-8)


@pytest.fixture(scope="module")
def ur10():
    return chip_smoke.build("ur10")


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_require_gpu_refuses_cpu():
    from graphik_tpu.utils.profiling import require_gpu

    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        require_gpu()


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_cpu_and_prints_no_result(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu(capsys):
    import bench

    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_build_and_params():
    for name in ("ur10", "ur10_table"):
        ps = chip_smoke.build(name)
        assert ps.N >= 16
        params, polish = chip_smoke.production_params(name)
        assert params.plateau_every == 16 and params.backend is None
        assert polish.maxiter == 10
    with pytest.raises(ValueError):
        chip_smoke.build("kuka")


def test_goals_are_float32(ur10):
    T = chip_smoke.goals(ur10, 3)
    assert T.dtype == np.float32 and T.shape[0] == 3


@pytest.mark.parametrize("name", ["ur10", "ur10_table"])
def test_parity_phase_tiny(name, interpret_kernel, capsys):
    res = chip_smoke.phase_parity(name, chip_smoke.build(name), 4, "cpu")
    assert res["Y_within_tol"] == 1.0 and res["num_inner_equal"] == 1.0
    (line,) = _lines(capsys)
    assert line["phase"] == "parity" and line["card"] == "cpu"


def test_backends_phase_tiny(ur10, interpret_kernel, capsys):
    res = chip_smoke.phase_backends("ur10", ur10, 4, "cpu", params=TINY,
                                    polish=POLISH)
    assert set(res) == {"pallas", "edge", "dense"}
    for r in res.values():
        assert r["wall_s"] > 0 and 0.0 <= r["success_rate"] <= 1.0
        assert "ratio_to_f64" in r
    assert res["pallas"]["solve_memory"] is not None
    assert [x["backend"] for x in _lines(capsys)] == ["pallas", "edge",
                                                      "dense"]


def test_init_phase_tiny(ur10, capsys, monkeypatch):
    edge = dataclasses.replace(TINY, backend="edge")
    monkeypatch.setattr(chip_smoke, "production_params",
                        lambda name: (edge, POLISH))
    res = chip_smoke.phase_init(ur10, 4, "cpu")
    assert set(res) == {"subspace", "eigh"}
    assert all(r["prepare_wall_s"] > 0 for r in res.values())


def test_restarts_phase_tiny(ur10, interpret_kernel):
    res = chip_smoke.phase_restarts(ur10, 4, "cpu", n_restarts=2,
                                    params=TINY, polish=POLISH)
    assert res["config"] == "ur10_restarts2" and res["batch"] == 4


def test_sharded_phase_tiny(ur10, interpret_kernel, monkeypatch):
    """The --four path on 4 of the 8 virtual CPU devices."""
    monkeypatch.setattr(chip_smoke, "production_params",
                        lambda name: (TINY, POLISH))
    res = chip_smoke.phase_sharded(ur10, 2, 4, "cpu")
    assert res["devices"] == 4 and res["batch"] == 8
    assert res["success_flags_agree"] >= 0.995

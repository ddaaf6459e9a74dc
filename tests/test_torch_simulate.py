"""The ported slice as a whole: `simulate` and `serve_loop` against the
JAX `simulate`.

Both packages get the same inputs: a numpy `diurnal_table` played back by
`TableCarbonSource` and a numpy [T, M] arrival table (a test-local
callable on each side), so no random stream needs to agree. Queues are
bitwise equal to the reference; the emission series agree to rtol 1e-6
(sums in another order); the port's record modes give bitwise equal
scalar series; the port's `serve_loop` reproduces its `simulate`
trajectory bitwise.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import carbon as jcarbon  # noqa: E402
from repro.configs import paper_workloads as jpw  # noqa: E402
from repro_torch.configs import paper_workloads as tpw  # noqa: E402
from repro_torch.serve import loop as tserve  # noqa: E402

f32 = np.float32
T = 200
STRIDE = 10
SCALARS = ("emissions", "cum_emissions", "dispatched", "processed", "energy_edge", "energy_cloud")


def _setup(name):
    if name == "paper":
        jspec, tspec, amax = jpw.paper_spec(), tpw.paper_spec(), 400
    else:
        rng = np.random.default_rng(7)
        M, N = 64, 8
        fields = dict(pe=rng.uniform(1, 8, M).astype(f32), pc=rng.uniform(2, 100, (M, N)).astype(f32),
                      Pe=3000.0, Pc=rng.uniform(1e3, 2e4, N).astype(f32))
        jspec, tspec, amax = J.NetworkSpec(**fields), P.NetworkSpec(**fields), 60
    table = P.diurnal_table(T, tspec.N, np.random.default_rng(1))
    np.testing.assert_array_equal(table, jcarbon.diurnal_table(T, jspec.N, np.random.default_rng(1)))
    arrivals = np.random.default_rng(2).integers(0, amax + 1, (T, tspec.M)).astype(f32)
    return jspec, tspec, table, arrivals


def _policies(pname):
    if pname == "carbon":
        return J.CarbonIntensityPolicy(V=0.05), P.CarbonIntensityPolicy(V=0.05)
    return J.QueueLengthPolicy(), P.QueueLengthPolicy()


def _port_run(pol, tspec, table, arrivals, record, steps=T):
    tab = torch.from_numpy(arrivals)
    return P.simulate(pol, tspec, P.TableCarbonSource(table=table),
                      lambda t, seed, device: tab[t], steps, 0, record=record, device="cpu")


@pytest.mark.parametrize("pname", ["carbon", "queue"])
@pytest.mark.parametrize("name", ["paper", "random64x8"])
def test_simulate_matches_jax_in_every_record_mode(name, pname):
    jspec, tspec, table, arrivals = _setup(name)
    jpol, tpol = _policies(pname)
    jarr = jnp.asarray(arrivals)
    ref = J.simulate(jpol, jspec, J.TableCarbonSource(table=table), lambda t, k: jarr[t], T,
                     jax.random.PRNGKey(0), record="full")
    full = _port_run(tpol, tspec, table, arrivals, "full")
    np.testing.assert_array_equal(full.Qe.numpy(), np.asarray(ref.Qe))
    np.testing.assert_array_equal(full.Qc.numpy(), np.asarray(ref.Qc))
    for field in SCALARS:
        np.testing.assert_allclose(getattr(full, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=1e-6, err_msg=field)
    np.testing.assert_array_equal(full.dispatched.numpy(), np.asarray(ref.dispatched))
    np.testing.assert_array_equal(full.processed.numpy(), np.asarray(ref.processed))

    summary = _port_run(tpol, tspec, table, arrivals, "summary")
    strided = _port_run(tpol, tspec, table, arrivals, STRIDE)
    for res in (summary, strided):
        for field in SCALARS:
            assert torch.equal(getattr(res, field), getattr(full, field)), field
    assert summary.Qc.shape == (1, tspec.M, tspec.N)
    assert torch.equal(summary.Qc[0], full.Qc[-1]) and torch.equal(summary.Qe[0], full.Qe[-1])
    assert torch.equal(strided.Qc, full.Qc[STRIDE - 1::STRIDE])
    assert torch.equal(strided.Qe, full.Qe[STRIDE - 1::STRIDE])
    assert float(summary.final_backlog) == float(full.final_backlog)
    assert float(P.mean_rate_stability_metric(summary)) == float(full.final_backlog / T)


def test_record_mode_validation():
    _, tspec, table, arrivals = _setup("paper")
    for bad in (0, 7, "every", True):
        with pytest.raises(ValueError, match="record"):
            _port_run(P.QueueLengthPolicy(), tspec, table, arrivals, bad)


def test_paper_spec_equals_reference():
    j, t = jpw.paper_spec(), tpw.paper_spec()
    for field in ("pe", "pc", "Pe", "Pc"):
        np.testing.assert_array_equal(np.asarray(getattr(t, field)), np.asarray(getattr(j, field)))
    assert tpw.TABLE_I == jpw.TABLE_I
    assert (tpw.P_EDGE, tpw.P_CLOUD, tpw.N_CLOUDS, tpw.A_MAX, tpw.V_PAPER, tpw.C_MAX_RANDOM) == (
        jpw.P_EDGE, jpw.P_CLOUD, jpw.N_CLOUDS, jpw.A_MAX, jpw.V_PAPER, jpw.C_MAX_RANDOM)


class FakeClock:
    """Integer-second ticks, so latencies are exact."""

    def __init__(self):
        self.t = 0
        self.calls = 0

    def __call__(self):
        self.calls += 1
        self.t += 1
        return float(self.t)


def test_serve_trajectory_bitwise_equals_simulate(tmp_path):
    _, tspec, table, arrivals = _setup("random64x8")
    steps = 48
    tab = torch.from_numpy(arrivals)
    pol = P.CarbonIntensityPolicy(V=0.05)
    clock = FakeClock()
    rep = tserve.serve_loop(pol, tspec, P.TableCarbonSource(table=table),
                            lambda t, seed, device: tab[t], steps, 0, warmup=2, clock=clock,
                            outdir=tmp_path, stem="parity", flush_every=8, device="cpu")
    res = _port_run(pol, tspec, table, arrivals, "full", steps=steps)
    backlog = np.array([float(res.Qe[t].sum() + res.Qc[t].sum()) for t in range(steps)])
    np.testing.assert_array_equal(rep.backlog, backlog)
    np.testing.assert_array_equal(rep.emissions, res.emissions.numpy())
    assert torch.equal(rep.state.Qe, res.Qe[-1]) and torch.equal(rep.state.Qc, res.Qc[-1])
    assert rep.tasks_dispatched == float(res.dispatched.double().sum())
    # the clock pattern: once before, twice per slot, once after
    assert clock.calls == 2 * steps + 2
    np.testing.assert_array_equal(rep.latency_us, np.full(steps, 1e6))
    assert rep.p50_us == rep.p99_us == 1e6 and rep.wall_s == 2 * steps + 1
    events = [json.loads(line) for line in (tmp_path / "parity.jsonl").read_text().splitlines()]
    slots = [e for e in events if e["event"] == "slot"]
    assert len(slots) == steps and events[-1]["event"] == "summary"
    np.testing.assert_array_equal(np.float32([e["emissions"] for e in slots]), rep.emissions)
    assert events[-1]["p50_us"] == rep.p50_us
    assert "repro_serve_latency_us_count 46" in (tmp_path / "parity.prom").read_text()


def test_age_fifo_known_sequence():
    fifo = tserve._AgeFifo()
    assert fifo.update(0, 10, 0) == 0
    assert fifo.update(1, 5, 4) == 1   # 6 of slot 0 still waiting
    assert fifo.update(2, 0, 6) == 1   # slot 0 drained, slot 1 is oldest
    assert fifo.update(3, 0, 10) == 0  # overdrain empties the queue


def test_serve_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_SMOKE", "1")
    rep = tserve.main(["--device", "cpu", "--slots", "12", "--types", "32", "--clouds", "3"])
    out = capsys.readouterr().out
    assert "decision latency p50" in out and rep.slots == 12
    assert rep.tasks_arrived >= 1e4


def test_table_helpers_equal_reference_and_sources_are_deterministic(tmp_path):
    np.testing.assert_array_equal(P.bursty_table(50, 4, np.random.default_rng(3)),
                                  jcarbon.bursty_table(50, 4, np.random.default_rng(3)))
    csv = tmp_path / "eso.csv"
    csv.write_text("datetime,a,b,c\n2022-01-01T00:00,100,50,70\nbad,row\n2022-01-01T00:30,110,55,x\n"
                   "2022-01-01T01:00,120,60,80\n")
    src, ref = P.from_eso_csv(str(csv), 2), jcarbon.from_eso_csv(str(csv), 2)
    np.testing.assert_array_equal(np.asarray(src.table), np.asarray(ref.table))
    # random sources: a function of (seed, t), in range, and of the right shape
    for source in (P.UKRegionalTraceSource(N=7), P.RandomCarbonSource(N=7)):
        a, b = P.materialize(source, 6, seed=4, device="cpu"), P.materialize(source, 6, seed=4, device="cpu")
        np.testing.assert_array_equal(a, b)
        assert a.shape == (6, 8) and a.dtype == np.float32 and a.min() >= 0 and a.max() <= 700
    arr = P.UniformArrivals(M=9, amax=5)
    x = arr(3, 11, "cpu")
    assert torch.equal(x, arr(3, 11, "cpu")) and x.shape == (9,) and 0 <= x.min() and x.max() <= 5
    pois = P.PoissonArrivals(rates=(1.0, 50.0, 500.0), clip=100)
    y = pois.to("cpu")(2, 0, "cpu")
    assert torch.equal(y, pois(2, 0, "cpu")) and float(y.max()) <= 100
    uk = P.uk_regional_table(5, 3, seed=9, device="cpu")
    np.testing.assert_array_equal(uk, P.materialize(P.UKRegionalTraceSource(N=3, seed=9), 5, device="cpu"))
    assert not np.array_equal(P.uk_regional_table(5, 3, seed=9, rotate=1, device="cpu"), uk)


@pytest.mark.parametrize("rotate", [0, 3])
def test_uk_trace_bitwise_equal_jax(rotate):
    """The UK source, float32 op by op with glibc's sinf and the twin's
    normal over XLA's log1p, is JAX's trace bitwise (JAX renders it under
    an eager vmap): its table over a week of slots and a run's slots."""
    got = P.uk_regional_table(336, 5, rotate=rotate, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jcarbon.uk_regional_table(336, 5, rotate=rotate)))
    src = P.UKRegionalTraceSource(N=5, seed=7)
    np.testing.assert_array_equal(
        P.materialize(src, 50, device="cpu"),
        np.asarray(jcarbon.materialize(jcarbon.UKRegionalTraceSource(N=5, seed=7), 50)))

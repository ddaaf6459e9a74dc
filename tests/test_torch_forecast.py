"""The forecast layer against the JAX package's `repro.forecast`.

Forecasters are replayed over the same table by both packages'
`rolling_forecasts` (JAX's under jit: a scan, where XLA:CPU contracts
EWMA's update and the error model into FMAs): Persistence,
SeasonalNaive, EWMA and the clairvoyant table forecaster are bitwise;
RidgeAR within rtol 1e-4 (LAPACK's solve against a fixed-order
elimination). The error model is bitwise (its `normal` is the twin's,
over XLA's log1p). LookaheadDPPPolicy runs fed by forecasters are held to JAX's
`simulate` / `simulate_fleet` (the fleet an argument of the jitted run):
queues, actions and counts bitwise, emissions rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.forecast as JF  # noqa: E402
import repro.network as JN  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.forecast as PF  # noqa: E402
import repro_torch.network as PN  # noqa: E402
from repro.configs import fleet_scenarios as jfs  # noqa: E402
from repro.configs import paper_workloads as jpw  # noqa: E402
from repro.core.carbon import diurnal_table  # noqa: E402
from repro.core.simulator import sweep_forecast_errors as jsweep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import paper_workloads as tpw  # noqa: E402
from repro_torch.kernels import numerics  # noqa: E402

f32 = np.float32
TABLE = diurnal_table(150, 5, np.random.default_rng(1))


def _pair(name, **kw):
    """The same forecaster from both packages (an `error` given as
    (bias, noise, seed))."""
    jkw, tkw = dict(kw), dict(kw)
    if "error" in kw:
        b, n, s = kw["error"]
        jkw["error"] = JF.ForecastErrorModel(bias=b, noise=n, seed=s)
        tkw["error"] = PF.ForecastErrorModel(bias=b, noise=n, seed=s)
    return getattr(JF, name)(**jkw), getattr(PF, name)(**tkw)


def _rolling(jfc, tfc, table=TABLE, key=3):
    ref = np.asarray(jax.jit(lambda t, k: JF.rolling_forecasts(jfc, t, key=k))(
        table, jax.random.PRNGKey(key)))
    got = PF.rolling_forecasts(tfc, table, key=key, device="cpu").numpy()
    return got, ref


@pytest.mark.parametrize("name,kw", [
    ("PersistenceForecaster", dict(H=8)),
    ("SeasonalNaiveForecaster", dict(H=8)),
    ("SeasonalNaiveForecaster", dict(H=16, period=24)),
    ("EWMAForecaster", dict(H=8)),
    ("EWMAForecaster", dict(H=4, alpha=0.55)),
    ("ClairvoyantTableForecaster", dict(H=8)),
    ("ClairvoyantTableForecaster", dict(H=16)),
])
def test_rolling_forecasts_bitwise_equal_jax(name, kw):
    got, ref = _rolling(*_pair(name, **kw))
    assert got.shape == ref.shape == (150, kw["H"], 6)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw,atol", [(dict(H=8), 0.0), (dict(H=4, lags=4, window=16, ridge=0.5), 1e-3)])
def test_ridge_ar_close_to_jax(kw, atol):
    """rtol 1e-4; the short window's rollout also reaches forecasts near
    0 (it clips at 0), where the solves' absolute difference, under
    1e-3 gCO2/kWh on intensities of 5-700, is what remains."""
    got, ref = _rolling(*_pair("RidgeARForecaster", **kw))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)
    with pytest.raises(ValueError, match="window"):
        PF.RidgeARForecaster(lags=8, window=10).init(5, device="cpu")


def test_ewma_update_is_contracted():
    """The single-rounded update is what JAX gives in its scan; two
    roundings of alpha*row + (1-alpha)*level differ from it."""
    _, ref = _rolling(*_pair("EWMAForecaster", H=2))
    level, unfused = TABLE[0], [TABLE[0]]
    for row in TABLE[1:]:
        level = (f32(0.3) * row + f32(0.7) * level).astype(f32)
        unfused.append(level)
    assert np.any(np.asarray(unfused) != ref[:, 1])


@pytest.mark.parametrize("bias,noise", [(0.0, 0.0), (0.1, 0.0), (-0.2, 0.0), (0.0, 0.2),
                                        (0.1, 0.2)])
def test_error_model_matches_jax(bias, noise):
    """The model's constants: bitwise, noise or none (the twin's normal is
    JAX's)."""
    got, ref = _rolling(*_pair("ClairvoyantTableForecaster", H=8, error=(bias, noise, 7)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 0], TABLE)  # lead 0 is exact


@pytest.mark.parametrize("bias,noise", [(0.0, 0.0), (0.15, 0.0), (0.0, 0.3), (-0.1, 0.2)])
def test_error_overrides_match_jax(bias, noise):
    """(bias, noise) handed to `init` (the fleet's lanes; traced values
    in JAX): fma(truth, 1+b, ((n*truth)*h)*eps); b = n = 0 is the truth
    bitwise."""
    jfc, tfc = _pair("ClairvoyantTableForecaster", H=8, error=(0.3, 0.4, 5))

    def jroll(t, k, b, n):
        carry = jfc.init(5, key=k, table=t, error=(b, n))
        return jax.lax.scan(lambda c, x: (c, jfc.predict(c, x)), carry, jnp.arange(150))[1]

    ref = np.asarray(jax.jit(jroll)(TABLE, jax.random.PRNGKey(2), jnp.float32(bias),
                                    jnp.float32(noise)))
    carry = tfc.init(5, key=2, table=TABLE, error=(bias, noise), device="cpu")
    got = torch.stack([tfc.predict(carry, t) for t in range(150)]).numpy()
    np.testing.assert_array_equal(got, ref)
    if bias == 0.0 and noise == 0.0:
        np.testing.assert_array_equal(got[:, 3], TABLE[(np.arange(150) + 3) % 150])


def test_forecast_errors_match_jax():
    """The sums run in float32 in XLA:CPU's order (`numerics.xla_sum`, read
    from the HLO: 32-row windows, split pad), so the metrics are JAX's
    bitwise wherever the forecasts are, eager and under jit; RidgeAR's
    forecasts (LAPACK's solve, limit L3) keep them within rtol 1e-6."""
    for name, kw in (("SeasonalNaiveForecaster", dict(H=8, period=48)),
                     ("RidgeARForecaster", dict(H=8)),
                     ("ClairvoyantTableForecaster", dict(H=8, error=(0.0, 0.1, 1)))):
        jfc, tfc = _pair(name, **kw)
        ref = JF.forecast_errors(jfc, TABLE, burn_in=64)
        jitted = jax.jit(lambda t: JF.forecast_errors(jfc, t, burn_in=64))(TABLE)
        got = PF.forecast_errors(tfc, TABLE, burn_in=64, device="cpu")
        for k in ("mae", "rmse", "mae_per_lead"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, err_msg=k)
            if name != "RidgeARForecaster":
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(jitted[k]), err_msg=k)


def test_rmse_takes_a_correctly_rounded_sqrt():
    """F7: a mean square of 40.955097 (errors 4 and 8.118509 on the one
    scored lead), where torch 2.13's float32 sqrt on the CPU gives
    6.3996167 and jnp.sqrt, jit and numpy 6.399617: `rmse` is JAX's
    bitwise (tolerance: none)."""
    table = np.array([[4.0, 8.118509], [0.0, 0.0]], f32)
    jfc, tfc = _pair("PersistenceForecaster", H=2)
    got = PF.forecast_errors(tfc, table, device="cpu")["rmse"].numpy()
    for ref in (JF.forecast_errors(jfc, table)["rmse"],
                jax.jit(lambda t: JF.forecast_errors(jfc, t)["rmse"])(table)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    assert got == np.sqrt(f32(40.955097)) == f32(6.399617)
    x = torch.tensor(f32(40.955097))
    assert numerics.sqrt_rn(x).item() == np.sqrt(f32(40.955097))


@pytest.mark.parametrize("H", [1, 16, 266, 267, 268, 1000, 4096])
def test_sqrt_of_the_leads_is_numpy_s(H):
    """F7: the error model's sqrt(h) over h = 0..H-1 is numpy's float32
    sqrt bitwise (torch's CPU sqrt is first an ulp off at h = 267)."""
    got = numerics.sqrt_rn(torch.arange(H, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(np.arange(H, dtype=f32)))


def test_error_model_past_lead_267_matches_jax():
    """F7: a clairvoyant forecaster with H = 300 (sqrt(h) rounds apart in
    torch's CPU sqrt at h = 267) is JAX's forecast bitwise."""
    jfc, tfc = _pair("ClairvoyantTableForecaster", H=300, error=(0.0, 0.1, 1))
    got, ref = _rolling(jfc, tfc, table=TABLE[:12])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("T", [1, 32, 33, 40, 150, 1100])
def test_xla_sum_is_jax_order(T):
    """`xla_sum` against jnp.sum over [T, 7, 6] (all axes, and per lead),
    eager and jitted, at row counts either side of one and two windows."""
    x = np.random.default_rng(T).standard_normal((T, 7, 6)).astype(f32) * 100
    tx = torch.from_numpy(x)
    for ref in (jnp.sum(x), jax.jit(jnp.sum)(x)):
        np.testing.assert_array_equal(numerics.xla_sum(tx.reshape(T, -1)).numpy(),
                                      np.asarray(ref))
    for ref in (jnp.sum(x, axis=(0, 2)), jax.jit(lambda a: jnp.sum(a, axis=(0, 2)))(x)):
        np.testing.assert_array_equal(numerics.xla_sum(tx.permute(1, 0, 2)).numpy(),
                                      np.asarray(ref))


def test_forecasters_on_lanes_equal_single_lanes():
    """A fleet's rows [F, N+1]: every forecaster's forecast per lane
    equals its single-lane run over that lane's table."""
    tables = np.stack([diurnal_table(80, 4, np.random.default_rng(s)) for s in range(3)])
    keys = torch.stack([torch.tensor([0, s]) for s in range(3)])
    for tfc in (PF.PersistenceForecaster(H=4), PF.SeasonalNaiveForecaster(H=4, period=12),
                PF.EWMAForecaster(H=4), PF.RidgeARForecaster(H=4, lags=3, window=12),
                PF.ClairvoyantTableForecaster(H=4, error=PF.ForecastErrorModel(0.1, 0.2, 3))):
        carry = tfc.init(4, key=keys, table=tables, device="cpu")
        lanes = []
        for t in range(80):
            carry = tfc.update(carry, torch.from_numpy(tables[:, t]))
            lanes.append(tfc.predict(carry, t))
        lanes = torch.stack(lanes, dim=1)
        for f in range(3):
            one = PF.rolling_forecasts(tfc, tables[f], key=keys[f], device="cpu")
            assert torch.equal(lanes[f], one), (type(tfc).__name__, f)


def test_clairvoyant_needs_a_table():
    with pytest.raises(ValueError, match="playback table"):
        PF.ClairvoyantTableForecaster().init(5, device="cpu")
    assert isinstance(PF.EWMAForecaster(), PF.Forecaster)


# ------------------------------------------------------------ lookahead runs


def _single(jpol, tpol, jfc, tfc, T=60, seed=0):
    table = diurnal_table(96, 5, np.random.default_rng(seed + 10))
    ref = jax.jit(lambda k: J.simulate(jpol, jpw.paper_spec(), J.TableCarbonSource(table=table),
                                       J.UniformArrivals(M=5, amax=300), T, k,
                                       forecaster=jfc))(jax.random.PRNGKey(seed))
    got = P.simulate(tpol, tpw.paper_spec(), P.TableCarbonSource(table=table),
                     P.UniformArrivals(M=5, amax=300), T, seed, device="cpu", forecaster=tfc)
    return got, ref


def _assert_sim(got, ref, names=("Qe", "Qc", "dispatched", "processed")):
    for name in names:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("emissions", "cum_emissions", "energy_edge", "energy_cloud"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-3, err_msg=name)


def test_lookahead_h1_equals_carbon_intensity():
    """H=1: row 0 is the observed present, so the run is CarbonIntensity's
    bitwise, on one lane and on a fleet."""
    table = diurnal_table(96, 5, np.random.default_rng(4))
    run = dict(spec=tpw.paper_spec(), carbon_source=P.TableCarbonSource(table=table),
               arrival_source=P.UniformArrivals(M=5), T=50, key=1, device="cpu")
    base = P.simulate(P.CarbonIntensityPolicy(V=0.2), **run)
    ahead = P.simulate(P.LookaheadDPPPolicy(V=0.2, H=1), **run,
                       forecaster=PF.ClairvoyantTableForecaster(H=1))
    for name in ("Qe", "Qc", "emissions", "dispatched", "processed"):
        assert torch.equal(getattr(base, name), getattr(ahead, name)), name
    from repro_torch.configs import fleet_scenarios as tfs

    fleet = tfs.build_fleet(["diurnal", "diurnal-slack"], per_kind=2, Tc=24, device="cpu")
    base = P.simulate_fleet(P.CarbonIntensityPolicy(V=0.2), fleet, 40, 0, device="cpu")
    for fc in (PF.ClairvoyantTableForecaster(H=1), PF.PersistenceForecaster(H=4)):
        ahead = P.simulate_fleet(P.LookaheadDPPPolicy(V=0.2, H=1), fleet, 40, 0, device="cpu",
                                 forecaster=fc)
        for name in ("Qe", "Qc", "emissions", "dispatched", "processed"):
            assert torch.equal(getattr(base, name), getattr(ahead, name)), name


@pytest.mark.parametrize("H", [4, 8])
def test_lookahead_perfect_forecasts_match_jax(H):
    jpol = J.LookaheadDPPPolicy(V=0.2, H=H, discount=1.0, defer_weight=3.0)
    tpol = P.LookaheadDPPPolicy(V=0.2, H=H, discount=1.0, defer_weight=3.0)
    got, ref = _single(jpol, tpol, JF.ClairvoyantTableForecaster(H=H),
                       PF.ClairvoyantTableForecaster(H=H))
    _assert_sim(got, ref)
    base = P.simulate(P.CarbonIntensityPolicy(V=0.2), tpw.paper_spec(),
                      P.TableCarbonSource(table=diurnal_table(96, 5, np.random.default_rng(10))),
                      P.UniformArrivals(M=5, amax=300), 60, 0, device="cpu")
    assert not torch.equal(base.Qc, got.Qc)  # the horizon changes the schedule
    jf = jfs.build_fleet(["diurnal", "diurnal-slack"], per_kind=2, Tc=24)
    ref = jax.jit(lambda fl, k: J.simulate_fleet(jpol, fl, 40, k, forecaster=JF.ClairvoyantTableForecaster(H=H)))(
        jf, jax.random.PRNGKey(0))
    got = P.simulate_fleet(tpol, convert.fleet_from_reference(jf), 40, 0, device="cpu",
                           forecaster=PF.ClairvoyantTableForecaster(H=H))
    _assert_sim(got, ref)


@pytest.mark.parametrize("name,kw", [
    ("PersistenceForecaster", dict(H=8)),
    ("SeasonalNaiveForecaster", dict(H=8, period=12)),
    ("EWMAForecaster", dict(H=8)),
    ("ClairvoyantTableForecaster", dict(H=8, error=(0.0, 0.2, 7))),
])
def test_lookahead_fleet_with_forecasters_matches_jax(name, kw):
    """The bench's la_H8 configurations on a small fleet."""
    jfc, tfc = _pair(name, **kw)
    jpol, tpol = J.LookaheadDPPPolicy(V=0.2, H=8), P.LookaheadDPPPolicy(V=0.2, H=8)
    jf = jfs.build_fleet(["diurnal", "diurnal-slack"], per_kind=2, Tc=24)
    ref = jax.jit(lambda fl, k: J.simulate_fleet(jpol, fl, 40, k, forecaster=jfc))(
        jf, jax.random.PRNGKey(0))
    got = P.simulate_fleet(tpol, convert.fleet_from_reference(jf), 40, 0, device="cpu",
                           forecaster=tfc)
    _assert_sim(got, ref)


def test_forecasted_carbon_source_matches_jax():
    """A functional source serving its own noisy forecast (the
    RandomCarbonSource stream, JAX's bits), one lane."""
    err = (0.05, 0.1, 3)
    jfc = JF.ForecastedCarbonSource(J.RandomCarbonSource(N=5), H=4,
                                    error=JF.ForecastErrorModel(*err))
    tfc = PF.ForecastedCarbonSource(P.RandomCarbonSource(N=5), H=4,
                                    error=PF.ForecastErrorModel(*err))
    jpol, tpol = J.LookaheadDPPPolicy(V=0.05, H=4), P.LookaheadDPPPolicy(V=0.05, H=4)
    ref = jax.jit(lambda k: J.simulate(jpol, jpw.paper_spec(), jfc, J.UniformArrivals(M=5), 40,
                                       k, forecaster=jfc))(jax.random.PRNGKey(5))
    got = P.simulate(tpol, tpw.paper_spec(), tfc, P.UniformArrivals(M=5), 40, 5, device="cpu",
                     forecaster=tfc)
    _assert_sim(got, ref)


def test_sweep_forecast_errors_bias_lanes_match_jax():
    """One fleet call sweeping (bias, noise) over its lanes: the zero
    lane is the perfect forecast bitwise, every lane matches JAX's."""
    jf = jfs.build_fleet(["diurnal"], per_kind=4, Tc=24)
    bias, noise = [0.0, 0.2, -0.15, 0.1], [0.0, 0.0, 0.0, 0.0]
    jpol, tpol = J.LookaheadDPPPolicy(V=0.2, H=8), P.LookaheadDPPPolicy(V=0.2, H=8)
    jfe = jsweep(jf, bias, noise)
    tfe = P.sweep_forecast_errors(convert.fleet_from_reference(jf), bias, noise)
    assert tfe.err_bias.dtype == np.float32 and tfe.err_bias.shape == (4,)
    ref = jax.jit(lambda fl, k: J.simulate_fleet(jpol, fl, 40, k,
                                                 forecaster=JF.ClairvoyantTableForecaster(H=8)))(
        jfe, jax.random.PRNGKey(0))
    got = P.simulate_fleet(tpol, tfe, 40, 0, device="cpu",
                           forecaster=PF.ClairvoyantTableForecaster(H=8))
    _assert_sim(got, ref)
    perfect = P.simulate_fleet(tpol, convert.fleet_from_reference(jf), 40, 0, device="cpu",
                               forecaster=PF.ClairvoyantTableForecaster(H=8))
    assert torch.equal(got.Qc[0], perfect.Qc[0]) and not torch.equal(got.Qc[1], perfect.Qc[1])
    # noisy lanes, on the same fleet: JAX's normal where the twin's agrees
    tfn = P.sweep_forecast_errors(convert.fleet_from_reference(jf), 0.0, [0.0, 0.1, 0.2, 0.3])
    noisy = P.simulate_fleet(tpol, tfn, 40, 0, device="cpu",
                             forecaster=PF.ClairvoyantTableForecaster(H=8))
    assert torch.equal(noisy.Qc[0], perfect.Qc[0])
    assert bool(torch.isfinite(noisy.emissions).all())


def test_wan_fleet_with_forecaster_matches_jax():
    """NetworkAwareDPP(H=4) fed perfect forecasts on a WAN fleet."""
    jf = jfs.build_network_fleet(["congested-uplink"], per_kind=3, Tc=24)
    jpol, tpol = JN.NetworkAwareDPPPolicy(V=0.1, H=4), PN.NetworkAwareDPPPolicy(V=0.1, H=4)
    ref = jax.jit(lambda fl, k: J.simulate_fleet(jpol, fl, 40, k,
                                                 forecaster=JF.ClairvoyantTableForecaster(H=4)))(
        jf, jax.random.PRNGKey(0))
    got = P.simulate_fleet(tpol, convert.fleet_from_reference(jf), 40, 0, device="cpu",
                           forecaster=PF.ClairvoyantTableForecaster(H=4))
    _assert_sim(got, ref, ("Qe", "Qc", "Qt", "dispatched", "delivered", "processed"))
    blind = P.simulate_fleet(tpol, convert.fleet_from_reference(jf), 40, 0, device="cpu")
    assert not torch.equal(blind.Qc, got.Qc)


# ------------------------------------------------------------ chip_smoke's anchor


def test_forecast_anchors_pinned():
    """FORECAST_JAX, which chip_smoke.py phase 4e holds the card to, is
    jax 0.9.0's `bench_forecast_lookahead` (F16 per kind, T=192, V=0.2,
    PRNGKey(0)): each row's mean reduction against CarbonIntensity."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    cs_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs_mod)
    key = jax.random.PRNGKey(0)
    T, V = cs_mod.T_FC_ANCHOR, cs_mod.V_FC
    jmods = {"core": J, "forecast": JF}
    for kind in cs_mod.FC_KINDS:
        fleet = jfs.build_fleet([kind], per_kind=cs_mod.FC_PER_KIND, Tc=96, seed=0)

        def run(pol, fc=None):
            return np.asarray(jax.jit(lambda fl, k: J.simulate_fleet(pol, fl, T, k, forecaster=fc))(
                fleet, key).cum_emissions[:, -1])

        base = run(J.CarbonIntensityPolicy(V=V))
        for row, (pol, fc) in cs_mod.forecast_rows(jmods, V).items():
            got = float(100.0 * (1.0 - (run(pol, fc) / base)).mean())
            assert got == cs_mod.FORECAST_JAX[kind][row], (kind, row, got)

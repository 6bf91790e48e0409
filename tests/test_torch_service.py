"""One-shot batched serving in the PyTorch port against the JAX package's
offline compile.

Mixed-length requests share one length bucket and run masked; every
served result must equal the JAX package's offline ``graph.compile(t)`` at
the request's true length: ``out`` at atol 1e-5 and ``mel_tap`` at rtol =
atol = 1e-4 (``examples/speech_enhancement.py``'s streamed-vs-offline
tolerances).  The JAX package's own served results are not the oracle:
its masked bucket runs feed the mask CNN the zero frames past a row's end.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import signal as jsig
from repro.serving import SignalService as JService
from repro_torch import signal as tsig
from repro_torch.convert import params_from_jax
from repro_torch.pipelines import speech_enhancement as tse
from repro_torch.serving import SigSched, SignalRequest, SignalService

LENGTH, CH = 1024, (2, 4, 4, 1)
LENS = [LENGTH - 100 - 80 * i for i in range(5)]   # one bucket: 1024


def _jax_example():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "speech_enhancement.py"
    spec = importlib.util.spec_from_file_location("_fig9_example_svc", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JSE = _jax_example()


def _data(seed=1):
    rng = np.random.default_rng(seed)
    cnn = [(rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci))
           .astype(np.float32) for ci, co in zip(CH[:-1], CH[1:])]
    xs = [rng.standard_normal(t).astype(np.float32) for t in LENS]
    return cnn, xs


def _serve(backend, device="cpu", batch_size=4):
    cnn, xs = _data()
    svc = SignalService(batch_size=batch_size, backend=backend,
                        device=device)
    svc.register("se", tse.build_graph(LENGTH, ch=CH),
                 params={"mask": params_from_jax(cnn, device=device)})
    res = svc.serve([SignalRequest(rid=i, graph="se", samples=x)
                     for i, x in enumerate(xs)])
    return svc, res


def _jax_offline(i):
    cnn, xs = _data()
    c = _JSE.build_graph(LENGTH, ch=CH).compile(LENS[i])
    params = dict(c.init_params())
    params["mask"] = [jnp.asarray(w) for w in cnn]
    out = c(jnp.asarray(xs[i][None]), params)
    return {k: np.asarray(v)[0] for k, v in out.items()}


def _check(res, i):
    want = _jax_offline(i)
    assert set(res[i]) == {"out", "mel_tap"}
    for k, (rtol, atol) in (("out", (0, 1e-5)), ("mel_tap", (1e-4, 1e-4))):
        assert res[i][k].shape == want[k].shape
        np.testing.assert_allclose(res[i][k], want[k], rtol=rtol, atol=atol)


@pytest.mark.parametrize("backend", ["reference", "hopper"])
@pytest.mark.parametrize("i", range(len(LENS)))
def test_served_equals_reference_offline(backend, i):
    svc, res = _serve(backend)
    assert sorted(res) == list(range(len(LENS)))
    assert svc.stats["bucketed"] == 2 and svc.stats["compiles"] == 1
    _check(res, i)


def test_bucketing_matches_reference():
    jsvc = JService(batch_size=4)
    tsvc = SignalService(batch_size=4, device="cpu")
    for svc, pkg in ((jsvc, jsig), (tsvc, tsig)):
        g = pkg.SignalGraph("rt")
        g.stft("spec", frame=64, hop=32)
        g.istft("out", "spec", hop=32)
        g.outputs("out")
        svc.register("g", g)
    for t in (64, 65, 100, 128, 300, 512, 1000):
        assert tsvc.bucket_for("g", t) == jsvc.bucket_for("g", t)
    assert tsvc.group_cost(("g", 512), 3) == jsvc.group_cost(("g", 512), 3)


def test_pinned_buckets_and_overflow_match_reference():
    jsvc = JService(batch_size=4, buckets=[128, 256])
    tsvc = SignalService(batch_size=4, buckets=[256, 128], device="cpu")
    for svc, pkg in ((jsvc, jsig), (tsvc, tsig)):
        g = pkg.SignalGraph("rt")
        g.stft("spec", frame=64, hop=32)
        g.istft("out", "spec", hop=32)
        g.outputs("out")
        svc.register("g", g)
    for t in (64, 129, 256, 700):
        assert tsvc.bucket_for("g", t) == jsvc.bucket_for("g", t)
    assert tsvc.stats["bucket_overflow"] == jsvc.stats["bucket_overflow"] == 1


def test_fifo_waves_and_pending_groups():
    cnn, xs = _data()
    svc = SignalService(batch_size=2, device="cpu")
    svc.register("se", tse.build_graph(LENGTH, ch=CH),
                 params={"mask": params_from_jax(cnn, device="cpu")})
    for i, x in enumerate(xs):
        svc.submit(SignalRequest(rid=i, graph="se", samples=x))
    (grp,) = svc.pending_groups()
    assert grp.key == ("se", LENGTH) and grp.count == len(xs)
    assert sorted(svc.step()) == [0, 1]
    assert sorted(svc.step(svc.make_pick(("se", LENGTH)))) == [2, 3]
    assert svc.pending() == 1 and sorted(svc.step()) == [4]
    assert svc.pending() == 0 and svc.step() == {}


def test_submit_validates_samples():
    svc = SignalService(device="cpu")
    svc.register("se", tse.build_graph(LENGTH, ch=CH))
    with pytest.raises(ValueError, match="1-D"):
        svc.submit(SignalRequest(0, "se", np.zeros((2, 300), np.float32)))
    with pytest.raises(ValueError, match="too short"):
        svc.submit(SignalRequest(1, "se", np.zeros(100, np.float32)))
    with pytest.raises(KeyError):
        svc.submit(SignalRequest(2, "nope", np.zeros(300, np.float32)))


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "SigMesh")])
def test_later_slices_raise(kw, item):
    """SigMesh is ported (tests/test_torch_mesh*.py): a mesh of a kind it
    does not take is refused, naming what it takes."""
    with pytest.raises(TypeError, match=item):
        SignalService(device="cpu", **kw)


@pytest.mark.parametrize("scheduler", [None, True, {"row_budget": 2}])
def test_scheduler_option_builds_sigsched(scheduler):
    """The port's service dispatches through SigSched by default, as the
    JAX package's does; ``scheduler=False`` keeps the FIFO pick."""
    kw = {} if scheduler is None else {"scheduler": scheduler}
    svc = SignalService(device="cpu", **kw)
    assert isinstance(svc.scheduler, SigSched) and svc.mesh is None
    assert svc.scheduler.row_budget == (2 if isinstance(scheduler, dict)
                                        else None)
    assert SignalService(device="cpu", scheduler=False).scheduler is None


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        SignalService()

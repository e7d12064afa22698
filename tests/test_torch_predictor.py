"""The port's predictor against the JAX package's, on the CPU.

``ErnestPredictor``'s θ comes from 2000 float32 projected-gradient steps
in each framework; the two take their products and the spectral norm in
another order, so θ is held within rtol 1e-3 (atol 1e-3 for a component
pinned at 0). The roofline predictor is pure Python: with the port's card
constants set to the reference's v5e values it must give the reference's
numbers exactly.
"""
import numpy as np
import pytest
import torch

from repro.cluster.catalog import paper_cluster
from repro.cluster.workloads import JOB_PROFILES
from repro.core import predictor as jpred
from repro_torch.cluster.catalog import paper_cluster as t_paper_cluster
from repro_torch.cluster.workloads import JOB_PROFILES as T_JOB_PROFILES
from repro_torch.core import predictor as tpred

CPU = torch.device("cpu")


def _model_data():
    """tests/test_predictor.py's two inputs: data of the Ernest model
    itself, and a USL curve's runtimes at five counts."""
    theta = np.asarray([5.0, 120.0, 2.0, 0.3])
    n = np.asarray([1, 2, 4, 6, 8, 12, 16], float)
    X = np.stack([np.ones_like(n), 1 / n, np.log(n), n], 1)
    train_n = [1, 2, 4, 8, 16]
    curve = JOB_PROFILES["airline-delay"].curves["m5.4xlarge"]
    return {"model": (n, X @ theta),
            "usl": (train_n, curve.runtime(np.asarray(train_n)))}


@pytest.mark.parametrize("data", ["model", "usl"])
def test_ernest_theta_matches_reference(data):
    n, y = _model_data()[data]
    want = jpred.ErnestPredictor.fit(n, y).theta
    got = tpred.ErnestPredictor.fit(n, y, device=CPU).theta
    assert got.dtype == np.float32 and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_ernest_claims_hold_on_the_port():
    """tests/test_predictor.py's two claims, on the port: data of the
    model is fit near-exactly, and a USL curve's held-out counts come out
    under 20% mean error (the paper's Ernest claim)."""
    n, y = _model_data()["model"]
    pred = tpred.ErnestPredictor.fit(n, y, device=CPU)
    assert (np.abs(pred.predict(n) - y) / y).max() < 0.05
    curve = T_JOB_PROFILES["airline-delay"].curves["m5.4xlarge"]
    train_n = [1, 2, 4, 8, 16]
    pred = tpred.ErnestPredictor.fit(train_n,
                                     curve.runtime(np.asarray(train_n)),
                                     device=CPU)
    test_n = np.asarray([3, 6, 10, 12])
    truth = curve.runtime(test_n)
    assert (np.abs(pred.predict(test_n) - truth) / truth).mean() < 0.20


def test_ernest_fit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpred.ErnestPredictor.fit([1, 2, 4], [3.0, 2.0, 1.5])


def test_roofline_matches_reference_with_its_constants(monkeypatch):
    monkeypatch.setattr(tpred, "PEAK_FLOPS", jpred.PEAK_FLOPS)
    monkeypatch.setattr(tpred, "HBM_BW", jpred.HBM_BW)
    monkeypatch.setattr(tpred, "NVLINK_BW", jpred.ICI_BW)
    recs = {"yi-6b/train_4k": (1e18, 1e15, 1e12, 256),
            "mem-bound": (1e12, 5e14, 0.0, 8),
            "comm-bound": (1e12, 1e9, 4e13, 16)}
    jp, tp = jpred.RooflinePredictor(), tpred.RooflinePredictor()
    for key, args in recs.items():
        jp.add(key, jpred.RooflineRecord(*args))
        tp.add(key, tpred.RooflineRecord(*args))
    jc, tc = paper_cluster(), t_paper_cluster()
    for key in recs:
        for chips in (None, 4, 8, 64, 256):
            assert tp.predict(key, chips) == jp.predict(key, chips)
        want = jp.options_for(key, 1000, jc, chip_counts=(4, 8, 16))
        got = tp.options_for(key, 1000, tc, chip_counts=(4, 8, 16))
        assert [(o.label, o.duration, o.demands, o.cost) for o in got] \
            == [(o.label, o.duration, o.demands, o.cost) for o in want]


def test_roofline_uses_the_card_constants():
    """Unpatched, the terms use the H100's peaks: a memory-bound record
    takes bytes over 3.35 TB/s per chip."""
    rec = tpred.RooflineRecord(flops=1.0, bytes_hbm=3.35e12 * 8,
                               bytes_collective=0.0, chips=8)
    assert rec.runtime() == pytest.approx(1.0, rel=1e-12)
    assert tpred.RooflineRecord(989e12, 0.0, 0.0, 1).runtime() == 1.0

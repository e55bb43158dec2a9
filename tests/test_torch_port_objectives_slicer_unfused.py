"""The port's SLICER and UnFuSeD against the JAX package on the CPU: one
step of each from the same weights on each of four batches of views and labels (carried by
``models.convert.slicer_from_flax`` / ``unfused_from_flax``): the loss,
every gradient, every BatchNorm running statistic, SLICER's key encoder
(two EMA applications), queue and pointer (two enqueues), and the
converters' strict, exact round trip. The sizes and tolerances are
tests/test_torch_port_objectives.py's."""
import numpy as np
import pytest
import torch

from audiossl_tpu.objectives.slicer import Slicer as JaxSlicer
from audiossl_tpu.objectives.unfused import Unfused as JaxUnfused
from audiossl_tpu_torch.models.audiontt import AudioNTT2020Task6
from audiossl_tpu_torch.models.convert import slicer_from_flax, unfused_from_flax
from tests.test_torch_port_objectives import B, D, config, hold_steps, jax_state, port_objective, port_views

CASES = {
    "slicer": (JaxSlicer, slicer_from_flax, dict(instance_contrastive_dim=16, cluster_contrastive_dim=12)),
    "unfused": (JaxUnfused, unfused_from_flax, dict(task_label=5)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_objective(request):
    name = request.param
    jcls, convert, extra = CASES[name]
    cfg = config(name, **extra)
    jobj = jcls(cfg, axis_name=None)
    return (name, cfg, jobj, convert, *jax_state(jobj, 2))


def test_converter_round_trips_strictly_and_exactly(jax_objective):
    name, cfg, _, convert, params, batch_stats, ssl, _ = jax_objective
    sd = convert(params, batch_stats, ssl)
    obj = port_objective(name, cfg, sd)
    got = obj.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    if name == "slicer":
        clus = params["encoder"]["cluster_projector"]["Dense_1"]
        np.testing.assert_array_equal(got["encoder.cluster_projector.2.weight"].numpy(), np.asarray(clus["kernel"]).T)
        np.testing.assert_array_equal(got["queue"].numpy(), np.asarray(ssl.queue))
        assert not torch.equal(got["encoder.instance_projector.bias"], got["encoder_k.instance_projector.bias"])
    else:
        np.testing.assert_array_equal(got["classifier.bias"].numpy(), np.asarray(params["classifier"]["bias"]))
        assert got["p1.projector.0.weight"].shape == (5, 2048) and got["classifier.weight"].shape == (5, D)
    AudioNTT2020Task6(n_mels=64, d=D).load_state_dict(obj.export_state_dict(), strict=True)


def test_step_matches_jax(jax_objective):
    name, cfg, jobj, convert, params, batch_stats, ssl, views = jax_objective
    n_keys = 2 * B if name == "slicer" else 0
    obj = hold_steps(name, cfg, jobj, convert, params, batch_stats, ssl, views, n_keys)
    if name == "slicer":
        assert int(obj.queue_ptr) == 2 * B
        assert all(not p.requires_grad and p.grad is None for p in obj.encoder_k.parameters())
    else:
        with pytest.raises(ValueError, match="labels"):
            obj.loss(*port_views(views[0])[:2])

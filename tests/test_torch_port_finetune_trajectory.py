"""Two steps of the port's supervised MAST fine-tune against JAX's own
trainer (``train_finetune_mast``) on the same AudioSet-style data, from the
same initial weights, with the augmentations and drop path off: the losses
of both steps, the second after one layer-decay AdamW update, within 1e-5
(relative). MAST tiny cut to 4 blocks on both sides, 64 mels x 48 frames,
f32, B = 8. JAX's whole trainer runs once here (it compiles)."""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from audiossl_tpu_torch.models.convert import mast_classifier_from_flax
from audiossl_tpu_torch.train import finetune_mast as ft
from tests.test_torch_port_finetune_cli import N_CLASSES, data, one_thread_short_tiny  # noqa: F401 (fixtures)

TOL_LOSS = 1e-5


def test_two_steps_without_augmentations_match_the_jax_trainer(data, tmp_path, monkeypatch):
    """JAX's train_finetune_mast (on a mesh of one CPU device) and the
    port's, augmentations and drop path off, B = 8, from JAX's initial
    weights: the two steps' losses (the second after one layer-decay AdamW
    update) within 1e-5, as test_finetune_fsdp_matches_shard_map compares
    JAX's two paths."""
    from audiossl_tpu.train.finetune_mast import MASTClassifier as JaxClassifier
    from audiossl_tpu.train.finetune_mast import train_finetune_mast as jax_train

    def cfg(save):
        return {
            "run": {"batch_size": 8, "epochs": 1, "num_dataloader_workers": 1, "learning_rate": 1e-3,
                    "layer_decay": 0.75, "weight_decay": 0.05, "clip_grad_norm": 1.0, "save_path": save},
            "finetune": {"model_size": "tiny", "droppath_rate": 0.0, "compute_dtype": "f32", "freqm": 0, "timem": 0,
                         "norm_stats": {"mean": -13.9, "std": 5.3},
                         "input": {"type": "fbank", "sampling_rate": 16000, "length_wave": 0.5, "n_mels": 64,
                                   "target_length": 48, "mixup": 0.0, "noise": False}},
        }

    args = (str(data / "train.json"), str(data / "labels.csv"))
    jcfg = cfg(str(tmp_path / "jax"))
    jcfg["run"]["world_size"] = 1  # a mesh of one CPU device: one program to compile, not eight
    jax_train(jcfg, *args, max_steps=2)
    jmodel = JaxClassifier(num_classes=N_CLASSES, input_fdim=64, input_tdim=48, model_size="tiny", droppath_rate=0.0,
                           compute_dtype=None)
    init = jax.jit(lambda k: jmodel.init({"params": k}, jnp.zeros((2, 64, 48, 1)), False))(jax.random.key(31))["params"]
    sd = mast_classifier_from_flax(jax.tree.map(np.asarray, init))

    def from_jax(ft_cfg, n_classes, seed, device):
        model = ft.build_classifier(ft_cfg, n_classes)
        model.load_state_dict(sd)
        return model.to(device)

    monkeypatch.setattr(ft, "init_classifier", from_jax)
    ft.train_finetune_mast(cfg(str(tmp_path / "port")), *args, max_steps=2, device="cpu")

    def losses(save):
        with open(save + "_chkp/stats.jsonl") as f:
            return [rec["train_loss"] for rec in map(json.loads, f) if "step" in rec]

    want, got = losses(str(tmp_path / "jax")), losses(str(tmp_path / "port"))
    assert len(want) == len(got) == 2 and want[0] != want[1]
    for g, w in zip(got, want):
        assert abs(g - w) <= TOL_LOSS * abs(w), (got, want)
    shutil.rmtree(tmp_path, ignore_errors=True)  # its checkpoints, hundreds of MB: a whole run's disk stays bounded

"""The training entry point: the port's ``main`` in train mode (then test
mode, from the checkpoint it wrote) against the JAX package's
``run_trainer`` for 2 epochs from the same start weights on the same
fixture (data/synthetic.generate; RGB + Audio with MHA attention and
Fusion, 64-px crops, 2 segments, 7 verbs and 9 nouns, float32, dropout 0:
the two frameworks' noise streams cannot match). The JAX run starts from
the port's weights: its ``init_variables`` is replaced, in the test, by the
port's initial state dict carried by ``bridge.state_dict_to_jax``. The
JAX package's compile of its train and eval steps takes most of this
file's time (~60-100 s on the CPU); resume is in
tests/test_torch_port_resume.py.

A single tower would compile in half the time but does not compare: its
classifier's gradient (norm ~21 against ~1 behind Fusion) is clipped at
20 and moves the towers far in one step, and the late BatchNorms on 2x2
and 4x4 maps give gradients whose float32 noise between two exact
lowerings is ~10-25% of their size (tests/test_torch_port_train_step.py),
so the parameters part at the first step.

Tolerance: per-epoch train and validation losses rtol 1e-3; validation
accuracies within one clip's share; final parameters at the third-step
tier of tests/test_torch_port_train_step.py (rtol 5e-3 / atol 5e-4; this
run takes 4 steps).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import attention_based_tbn_tpu.tools.train as jax_train
from attention_based_tbn_tpu.config import load_config as jax_load_config
from attention_based_tbn_tpu.data import synthetic
from attention_based_tbn_tpu_torch import main as port_main
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.tools.train import checkpoint_stem
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

VIDEOS = ["P01_01", "P02_03"]
MODALITY = ["RGB", "Audio"]
EPOCHS = 2
NO_DROPOUT = ["model.attention.attn_dropout=0", "model.fusion_dropout=0"]


def _overrides(root, exp, *extra):
    split = os.path.join(root, "train_split.txt")
    return [
        f"data_dir={root}", f"out_dir={root}/out", f"exp_name={exp}", "num_workers=2",
        "data.flow.enable=false", "data.audio.audio_length=1.279",
        "data.train_scale_size=72", "data.train_crop_size=64", "data.test_scale_size=72",
        "data.test_crop_size=64", "model.num_classes={verb: 7, noun: 9}",
        "model.pretrained=false", "tpu.compute_dtype=float32", "tpu.mesh.data=1",
        "tpu.native_io=false", f"train.vid_list={split}", "train.batch_size=3",
        f"train.epochs={EPOCHS}", "train.num_segments=2", f"val.vid_list={split}",
        "val.batch_size=3", "val.num_segments=2", "train.save_best=true", *extra,
    ]


def _logger():
    logger = logging.getLogger("port_run_trainer")
    logger.setLevel(logging.INFO)
    return logger


def _history(stem):
    with open(stem + ".history.json") as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_run_trainer"))
    synthetic.generate(root, videos=VIDEOS, frames_per_video=60, actions_per_video=3,
                       image_hw=(72, 96), num_verbs=7, num_nouns=9)
    return root


@pytest.fixture(scope="module")
def against_jax(root):
    """The port's main (train 2 epochs, then test from the checkpoint) and
    the JAX package's run_trainer from the same start weights."""
    torch.set_num_threads(1)
    stem = os.path.join(root, "out", "tbn_weights", "port", "epic_tbn_bninception_RGB_Audio")
    over = _overrides(root, "port", *NO_DROPOUT, "tpu.platform=cpu", "train.enable=true",
                      "test.enable=true", "test.num_segments=2",
                      f"test.vid_list={os.path.join(root, 'train_split.txt')}",
                      "test.annotation_file=[annotations/epic_train_val.csv]",
                      f"test.pre_trained={stem}.pth", "tpu.profile_steps=1")
    test_results = port_main.main(over)
    cfg = load_config(overrides=over)
    start = build_model(cfg, MODALITY, device="cpu").state_dict()  # run_trainer's seeded init
    variables = jax.tree.map(jnp.asarray, state_dict_to_jax(start))
    jcfg = jax_load_config(overrides=_overrides(root, "jax", *NO_DROPOUT))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_train, "init_variables", lambda model, batch, rng: variables)
        jstate = jax_train.run_trainer(jcfg, _logger(), MODALITY)
    final = torch.load(stem + ".pth", map_location="cpu", weights_only=True)["model"]
    jstem = os.path.join(root, "out", "tbn_weights", "jax", "epic_tbn_bninception_RGB_Audio")
    return dict(cfg=cfg, stem=stem, history=_history(stem), jax_history=_history(jstem),
                params=state_dict_to_jax(final)["params"], start=state_dict_to_jax(start),
                jax_params=jax.tree.map(np.asarray, jstate.params), test_results=test_results)


def test_main_trains_then_tests_from_the_checkpoint(against_jax):
    stem, history = against_jax["stem"], against_jax["history"]
    assert os.path.isfile(stem + ".pth") and os.path.isfile(stem + "_best.pth")
    assert history["epoch"] == EPOCHS - 1 and len(history["train_loss"]) == EPOCHS
    assert stem == checkpoint_stem(against_jax["cfg"], MODALITY)
    (test_loss, test_acc, _), = against_jax["test_results"]
    assert np.isfinite(test_loss["total"]) and set(test_acc) == {"verb", "noun", "all_class"}
    log_dir = os.path.join(os.path.dirname(stem), "..", "..", "log", "port")
    run_dir = os.path.join(log_dir, os.listdir(log_dir)[0])
    with open(os.path.join(run_dir, "tbn_RGB_Audio.log")) as fh:
        log = fh.read()
    for line in ("Epoch: [1/2]", "Epoch: [2/2]", "Training completed", "Test_Loss"):
        assert line in log
    assert os.path.isfile(os.path.join(run_dir, "profile", "trace.json"))  # tpu.profile_steps
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        return
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(run_dir))


@pytest.mark.parametrize("curve", ["train_loss", "validation_loss"])
def test_losses_match_jax(against_jax, curve):
    got, want = against_jax["history"][curve], against_jax["jax_history"][curve]
    assert len(got) == len(want) == EPOCHS
    for epoch, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-3, err_msg=f"{epoch} {key}")


def test_accuracies_match_jax(against_jax):
    got = against_jax["history"]["validation_accuracy"]
    want = against_jax["jax_history"]["validation_accuracy"]
    assert set(got) == set(want) == {"verb", "noun", "all_class"}
    one_clip = 100.0 / 6 + 0.01  # 6 validation clips; Metric rounds to 2 decimals
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=one_clip, err_msg=key)


def test_final_parameters_match_jax(against_jax):
    leaves = lambda tree: {"/".join(str(k.key) for k in path): np.asarray(v)  # noqa: E731
                           for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    got, want = leaves(against_jax["params"]), leaves(against_jax["jax_params"])
    start = leaves(against_jax["start"]["params"])
    assert set(got) == set(want)
    moved = 0
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=5e-3, atol=5e-4, err_msg=key)
        moved += not np.array_equal(w, start[key])
    assert moved > 100


def test_train_mode_needs_a_card_unless_asked_for_the_cpu(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would train on it")
    over = _overrides(root, "nocard", "train.enable=true", "test.enable=false")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(over)
    assert not os.path.exists(os.path.join(root, "out", "tbn_weights", "nocard"))

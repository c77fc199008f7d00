"""Card-only checks of the visualizer's path (``cuda`` marker; they skip
without a card). They import no JAX, so they run on the card's machine:

    python -m pytest --noconftest tests/test_torch_port_vis_card.py -q

The general MultiheadAttention on the card against the CPU, and
``tools/vis.sweep`` (get_info's rows and scores) with the kernels on
(``pe_block`` and ``mha`` launched once a forward) against the same weights
with them off, as
``chip_smoke.py``'s ``vis_path`` checks them at full width."""

import csv
import os

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu_torch.data import synthetic
from attention_based_tbn_tpu_torch.models.attention import MultiheadAttention
from attention_based_tbn_tpu_torch.ops import kernels
from attention_based_tbn_tpu_torch.tools import vis
from attention_based_tbn_tpu_torch.utils.device import tf32_scope


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("length,same_kv", [(3, False), (1, False), (3, True)])
def test_general_mha_on_the_card_matches_the_cpu(card, length, same_kv):
    """float32 with TF32 off: 1e-5 (rtol and atol) against the CPU."""
    mha = MultiheadAttention(256, 4)
    mha.reset_parameters(torch.Generator().manual_seed(length))
    rng = np.random.default_rng(length)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((2, length, 256), (2, 13, 256), (2, 13, 256)))
    v = k if same_kv else v
    with torch.no_grad():
        want = mha.eval()(q, k, v, False)
        with tf32_scope("float32"):
            kc = k.cuda()
            got = mha.cuda()(q.cuda(), kc, kc if same_kv else v.cuda(), False)
    assert got[0].shape == (2, length, 256) and got[1].shape == (2, length, 13)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_get_info_kernels_on_matches_kernels_off_on_the_card(card, tmp_path):
    """bf16 at 64-px crops, 2 segments: the scores within rel-RMSE 0.04
    (tests/test_bf16_drift.py's bound) and the entropy within 1e-2 of the
    kernels-off run; pe_block and mha launched once a forward with the
    kernels on, never with them off."""
    root = str(tmp_path)
    synthetic.generate(root, videos=["P01_01"], frames_per_video=60, num_verbs=7, num_nouns=9)
    over = [f"data_dir={root}", f"out_dir={root}", "data.flow.enable=False",
            "data.audio.read_audio_pickle=False", "data.audio.audio_length=1.279",
            "data.test_scale_size=80", "data.test_crop_size=64",
            "model.num_classes={verb: 7, noun: 9}", "test.num_segments=2", "val.vid_list="]
    with open(os.path.join(root, "annotations", "epic_train_val.csv"), newline="") as fh:
        assert len(list(csv.DictReader(fh))) >= 2
    rows, scores = {}, {}
    for pallas in ("true", "false"):
        cfg, model, modality, _ = vis.initialize(over + [f"tpu.use_pallas={pallas}"])
        dataset = vis.create_dataset(cfg, modality)
        kernels.reset_launch_counts()
        rows[pallas], heads = vis.sweep(cfg, model, None, dataset, max_samples=2)
        launches = (kernels.pe_block.launches, kernels.mha.launches)
        assert launches == ((2, 2) if pallas == "true" else (0, 0))
        scores[pallas] = np.concatenate([heads["verb"], heads["noun"]], axis=1)
    on, off = scores["true"], scores["false"]
    assert np.sqrt(np.mean((on - off) ** 2)) < 0.04 * np.sqrt(np.mean(off ** 2))
    for a, b in zip(rows["true"], rows["false"]):
        assert a["uid"] == b["uid"] and abs(a["attn_entropy"] - b["attn_entropy"]) <= 1e-2

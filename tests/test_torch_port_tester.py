"""The evaluation entry point: the port's ``run_tester`` against the JAX
package's on the same fixture and the same ``.pth`` (written by the JAX
package's ``convert_back.save_reference_checkpoint``), with 10-crop, fast
consensus, the fused stem and the challenge JSON on, over a labelled and an
unlabelled annotation file; eval restore; and ``main``'s device rule.

Tolerance: loss and accuracy within 1e-4 (Metric rounds them to 5 and 2
decimals), challenge scores rtol 1e-4 / atol 5e-4 as the model tests'
logits (fp32 through ~60 layers summed in another order).
"""

import csv
import json
import logging
import os

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu.config import load_config as jax_load_config
from attention_based_tbn_tpu.data import synthetic
from attention_based_tbn_tpu.models.convert_back import save_reference_checkpoint
from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu.preprocessing.create_flow_pickle import process_video
from attention_based_tbn_tpu.tools.test import run_tester as jax_run_tester
from attention_based_tbn_tpu_torch import main as port_main
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.tools.test import load_state, run_tester
from attention_based_tbn_tpu_torch.utils.checkpoint import load_eval_weights
from torch_port_helpers import one_torch_thread, port_model  # noqa: F401 (autouse fixture)

VIDEOS = ["P01_01", "P02_03"]
MODALITY = ["RGB", "Flow", "Audio"]
UNLABELLED = ["uid", "participant_id", "video_id", "start_timestamp", "stop_timestamp",
              "start_frame", "stop_frame"]


def _overrides(root, out_dir, *extra):
    return [
        f"data_dir={root}", f"out_dir={out_dir}", "exp_name=tester", "num_workers=2",
        "data.audio.audio_length=1.279", "data.test_scale_size=40", "data.test_crop_size=32",
        "data.flow.read_flow_pickle=true", "data.flow.dir_prefix=flow_pickle",
        "model.num_classes={verb: 7, noun: 9}", "tpu.compute_dtype=float32",
        "tpu.mesh.data=1", "tpu.native_io=false", "test.num_segments=2", "test.batch_size=2",
        "test.ten_crop=true", "tpu.fast_consensus=true", "tpu.fused_stem=true",
        "test.save_results=true", f"test.vid_list={os.path.join(root, 'train_split.txt')}",
        "test.annotation_file=[annotations/epic_train_val.csv, annotations/test_s1.csv]",
        "test.results_file=[seen.json, unseen.json]", *extra,
    ]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """Two videos of two actions, .npz flow stacks, an unlabelled copy of
    the CSV, and seeded weights written as a reference-format .pth."""
    root = str(tmp_path_factory.mktemp("port_tester"))
    synthetic.generate(root, videos=VIDEOS, frames_per_video=60, actions_per_video=2,
                       image_hw=(40, 48), num_verbs=7, num_nouns=9)
    for vid in VIDEOS:
        process_video(os.path.join(root, "links", vid), os.path.join(root, "flow_pickle", vid),
                      5, "jpg")
    ann = os.path.join(root, "annotations")
    with open(os.path.join(ann, "epic_train_val.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    with open(os.path.join(ann, "test_s1.csv"), "w", newline="") as fh:
        writer = csv.DictWriter(fh, UNLABELLED)
        writer.writeheader()
        writer.writerows({k: r[k] for k in UNLABELLED} for r in rows)
    cfg = load_config(overrides=_overrides(root, root))
    model = port_model(cfg)
    pth = os.path.join(root, "weights.pth")
    jcfg = jax_load_config(overrides=_overrides(root, root))
    save_reference_checkpoint(pth, state_dict_to_jax(model.state_dict()),
                              JaxTBNSpec.from_config(jcfg, MODALITY))
    return root, pth, model.state_dict()


def _logger():
    logger = logging.getLogger("port_tester")
    logger.setLevel(logging.INFO)
    return logger


def _scores(path):
    with open(path) as fh:
        return json.load(fh)


def test_run_tester_matches_jax(fixture, caplog):
    root, pth, _ = fixture
    runs = {}
    for name, load, tester, kw in (("jax", jax_load_config, jax_run_tester, {}),
                                   ("port", load_config, run_tester, {"device": "cpu"})):
        out_dir = os.path.join(root, name)
        cfg = load(overrides=_overrides(root, out_dir, f"test.pre_trained={pth}"))
        with caplog.at_level(logging.INFO, logger="port_tester"):
            runs[name] = tester(cfg, _logger(), MODALITY, **kw), out_dir
    (got, port_dir), (want, jax_dir) = runs["port"], runs["jax"]
    assert len(got) == len(want) == 2 and got[1] is None and want[1] is None
    (loss, acc, conf), (jloss, jacc, jconf) = got[0], want[0]
    assert set(loss) == set(jloss) and set(acc) == set(jacc)
    for key in jloss:
        assert abs(loss[key] - jloss[key]) <= 1e-4, key
    for key in jacc:
        np.testing.assert_allclose(acc[key], jacc[key], atol=1e-4, err_msg=key)
    for key in jconf:
        np.testing.assert_array_equal(conf[key], jconf[key])
    for name in ("seen.json", "unseen.json"):
        mine = _scores(os.path.join(port_dir, "inferences", name))
        theirs = _scores(os.path.join(jax_dir, "inferences", name))
        assert list(mine["results"]) == list(theirs["results"]) == ["0", "1", "2", "3"]
        for uid, heads in theirs["results"].items():
            assert set(mine["results"][uid]) == set(heads) == {"verb", "noun"}
            for head, classes in heads.items():
                assert list(mine["results"][uid][head]) == list(classes)
                np.testing.assert_allclose(list(mine["results"][uid][head].values()),
                                           list(classes.values()), rtol=1e-4, atol=5e-4)
    assert any("sustained" in r.getMessage() for r in caplog.records)


def test_load_state_takes_the_reference_layouts(fixture, tmp_path):
    root, pth, state = fixture
    cfg = load_config(overrides=_overrides(root, root, f"test.pre_trained={pth}"))
    model = load_state(cfg, _logger(), MODALITY, device="cpu").model  # {"model": ...}
    for name, tensor in state.items():
        torch.testing.assert_close(model.state_dict()[name], tensor, rtol=0, atol=0, msg=name)

    # a flat state dict without the regenerated buffers, with a tower head
    flat = {k: v for k, v in state.items()
            if not (k.endswith("num_batches_tracked") or k.startswith("pe.0."))}
    flat["Base_RGB.last_linear.weight"] = torch.zeros(3, 1024)
    path = str(tmp_path / "flat.pth")
    torch.save(flat, path)
    left_out = load_eval_weights(model, path)
    assert "pe.0.pe" in left_out["not_in_file"]
    assert left_out["not_in_model"] == ["Base_RGB.last_linear.weight"]

    for broken in ({k: v for k, v in state.items() if k != "fusion.fusion_layer.0.bias"},
                   {**state, "fusion.extra": torch.zeros(1)}):
        torch.save(broken, path)
        with pytest.raises(KeyError, match="does not fit"):
            load_eval_weights(model, path)
    with pytest.raises(ValueError, match="convert_back"):
        load_eval_weights(model, str(tmp_path))  # an Orbax directory
    with pytest.raises(ValueError, match="pre_trained"):
        load_state(load_config(overrides=_overrides(root, root)), _logger(), MODALITY, "cpu")


def test_main_runs_on_cuda_unless_asked_for_the_cpu(fixture, tmp_path):
    root, pth, _ = fixture
    over = _overrides(root, str(tmp_path), f"test.pre_trained={pth}", "train.enable=false",
                      "test.enable=true", "data.rgb.enable=false",
                      "test.annotation_file=[annotations/test_s1.csv]",
                      "test.results_file=[unseen.json]")
    cfg = load_config(overrides=over)
    assert port_main.device_for(cfg) == "cuda"
    assert port_main.device_for(load_config(overrides=over + ["tpu.platform=cpu"])) == "cpu"
    with pytest.raises(ValueError, match="tpu.platform"):
        port_main.device_for(load_config(overrides=over + ["tpu.platform=tpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main.main(over)
        # training asks for the card before it builds anything
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main.main(over + ["train.enable=true", "test.enable=false"])
        assert not os.path.exists(os.path.join(str(tmp_path), "tbn_weights"))

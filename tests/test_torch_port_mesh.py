"""The port's data-parallel layer (``parallel/mesh.py``) on the CPU: its
config rules and card choice, the sharded loader against the JAX package's
``DataLoader(shard=...)``, ``batch_norm_train``'s global statistics on 2
gloo ranks against one process, and the whole train step on 2 ranks
against one process with dropout on.

The ranks are spawned processes (tests/torch_port_dist.py) that import
torch and the port only."""

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu.data.loader import DataLoader as JaxDataLoader
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.data.loader import DataLoader
from attention_based_tbn_tpu_torch.parallel import mesh
from torch_port_dist import batch_norm_case, run_ranks, train_steps_case
from torch_port_helpers import SMALL, configs, make_batch, one_torch_thread  # noqa: F401
from torch_port_helpers import port_model

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT")


@pytest.fixture
def env(monkeypatch):
    """No torchrun variables unless a test sets them."""
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)
    assert not torch.distributed.is_initialized()
    return monkeypatch


def _torchrun(monkeypatch, rank, world):
    for name, value in (("RANK", rank), ("WORLD_SIZE", world), ("LOCAL_RANK", rank),
                        ("LOCAL_WORLD_SIZE", world)):
        monkeypatch.setenv(name, str(value))


def test_one_process_without_torchrun(env):
    made = mesh.make_mesh(load_config(), "cpu")
    assert made == mesh.DataMesh(0, 1, 0, 1, torch.device("cpu"), None, False)
    assert made.size == 1 and made.is_primary()
    assert made.describe().startswith("Mesh: {'data': 1} over 1 device(s), 1 process(es)")
    assert not torch.distributed.is_initialized()


# (overrides, device, torchrun (rank, world) or None, error, words of the message)
RULES = [
    (["tpu.mesh.data=2"], "cpu", None, ValueError, "tpu.mesh.data=2 but 1 process"),
    (["tpu.mesh.data=4"], "cpu", (0, 2), ValueError, "--nproc_per_node=4"),
    (["gpu_ids=[0, 1]"], "cuda", None, ValueError, "torchrun --nproc_per_node=2"),
    (["gpu_ids=[0, 1, 2]"], "cuda", (1, 2), ValueError, "one id per process"),
    (["tpu.multihost=true"], "cpu", None, RuntimeError, "MASTER_ADDR"),
]


@pytest.mark.parametrize("overrides,device,torchrun,error,words", RULES)
def test_config_rules(env, overrides, device, torchrun, error, words):
    if torchrun is not None:
        _torchrun(env, *torchrun)
    with pytest.raises(error, match=words.replace("[", r"\[").replace(".", r"\.")):
        mesh.make_mesh(load_config(overrides=overrides), device)
    assert not torch.distributed.is_initialized()


# (cards visible, (local rank, local world), gpu_ids) -> (card, backend)
CARDS = [
    (2, (0, 1), [1], 1, None),       # gpu_ids=[1] on card 1, not card 0
    (2, (1, 2), [], 1, "nccl"),      # a card per rank
    (2, (1, 2), [1, 0], 0, "nccl"),
    (1, (1, 2), [], 0, "gloo"),      # more ranks than cards: shared over gloo
    (4, (1, 2), [3, 3], 3, "gloo"),  # a repeated id: shared
]


@pytest.mark.parametrize("count,local,ids,card,backend", CARDS)
def test_rank_card_and_backend(env, count, local, ids, card, backend):
    """The rank's card and the backend follow the topology (cards seen by
    the process, ranks on the host, gpu_ids); the card becomes current."""
    chosen, made = [], []
    env.setattr(torch.cuda, "is_available", lambda: True)
    env.setattr(torch.cuda, "device_count", lambda: count)
    env.setattr(torch.cuda, "set_device", chosen.append)
    env.setattr(torch.distributed, "init_process_group",
                lambda backend, **kw: made.append((backend, kw)))
    if local[1] > 1:
        _torchrun(env, *local)
        env.setenv("MASTER_ADDR", "localhost")
        env.setenv("MASTER_PORT", "1")
    cfg = load_config(overrides=[f"gpu_ids={ids}"])
    got = mesh.make_mesh(cfg, "cuda")
    assert got.device == torch.device("cuda", card)
    assert chosen == [torch.device("cuda", card)]
    assert got.backend == backend
    assert [b for b, _ in made] == ([backend] if backend else [])
    assert got.shared_card == (backend == "gloo")
    if got.shared_card:
        assert "share the card" in got.describe()


class IndexDataset:
    """Samples that carry their index and a draw of their rng."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, index, rng):
        return {"uid": index, "vid_id": "v", "start_time": 0.0, "stop_time": 1.0,
                "RGB": np.asarray([index, rng.integers(1 << 30)], np.int64),
                "labels": {"verb": index}}


# (world, dataset size, global batch, shuffle): full and ragged batches; in
# the last case three of four ranks hold nothing but pad rows
SHARDS = [(2, 12, 4, False), (2, 11, 4, True), (4, 16, 8, True), (4, 13, 8, False),
          (4, 9, 4, True)]


@pytest.mark.parametrize("world,size,batch,shuffle", SHARDS)
def test_loader_shards_match_jax(world, size, batch, shuffle):
    """Each rank's rows, targets, true size and global indices equal the
    JAX package's process-sharded loader's, epoch 1 of a shuffled order."""
    for rank in range(world):
        kw = dict(batch_size=batch, shuffle=shuffle, num_workers=2, seed=3, pad_to=world,
                  shard=(rank, world))
        ours = DataLoader(IndexDataset(size), **kw)
        theirs = JaxDataLoader(IndexDataset(size), **kw)
        ours.set_epoch(1)
        theirs.set_epoch(1)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) == -(-size // batch)
        for (b, t, m), (jb, jt, jm) in zip(got, want):
            np.testing.assert_array_equal(b["RGB"], jb["RGB"])
            np.testing.assert_array_equal(t["class"]["verb"], jt["class"]["verb"])
            assert m["batch_size"] == jm["batch_size"]
            np.testing.assert_array_equal(m["global_indices"], jm["global_indices"])
            assert b["RGB"].shape[0] * world >= m["batch_size"]


def test_loader_refuses_a_world_that_does_not_divide_the_batch():
    with pytest.raises(ValueError, match="must divide the global batch size 6"):
        DataLoader(IndexDataset(8), batch_size=6, shard=(0, 4))


@pytest.mark.parametrize("true_rows", [8, 7, 3])
def test_batch_norm_train_two_ranks(true_rows):
    """2 ranks holding 4 rows each of a global batch of 8 (``true_rows``
    real) against one process on all 8: output and input gradient rows,
    the ranks' summed gamma / beta gradients, and the running statistics
    of both ranks, within 1e-6. Without the backward all-reduce of the
    statistics the input gradients are wrong and the test fails."""
    mask_rows = None if true_rows == 8 else true_rows
    ranks = run_ranks("batch_norm", 2, 0, mask_rows)
    one = batch_norm_case(0, mask_rows)
    for key in ("y", "dx"):
        got = torch.cat([r[key] for r in ranks])
        np.testing.assert_allclose(got.numpy(), one[key].numpy(), atol=1e-6, err_msg=key)
    for key in ("dgamma", "dbeta"):
        got = ranks[0][key] + ranks[1][key]
        np.testing.assert_allclose(got.numpy(), one[key].numpy(), atol=1e-6, err_msg=key)
    for key in ("running_mean", "running_var"):
        assert torch.equal(ranks[0][key], ranks[1][key]), key
        np.testing.assert_allclose(ranks[0][key].numpy(), one[key].numpy(), atol=1e-6,
                                   err_msg=key)


# RGB + Audio, MHA attention and Fusion, dropout 0.5 on both (the default),
# 64-px crops, 2 segments, float32
DROPOUT = ["data.flow.enable=false", "data.train_crop_size=64",
           "model.attention.attn_dropout=0.5", "model.fusion_dropout=0.5"]
B = 4


def _step_data():
    """A ragged global batch (3 true rows; rank 1 holds the pad row), then
    a full one."""
    cfg, _ = configs(DROPOUT)
    steps = []
    for true_rows, seed in ((B - 1, 1), (B, 2)):
        batch = make_batch(cfg, b=B, seed=seed)
        rng = np.random.default_rng(100 + seed)
        targets = {"class": {"verb": rng.integers(0, 125, B).astype(np.int32),
                             "noun": rng.integers(0, 352, B).astype(np.int32)}}
        steps.append((batch, targets, true_rows))
    return cfg, steps


@pytest.fixture(scope="module")
def dropout_runs():
    torch.set_num_threads(1)
    cfg, steps = _step_data()
    model = port_model(cfg)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    overrides = SMALL + DROPOUT
    return run_ranks("train_steps", 2, overrides, initial, steps), \
        train_steps_case(overrides, initial, steps)


def test_two_ranks_hold_one_state(dropout_runs):
    (first, second), _ = dropout_runs
    assert first["world"] == second["world"] == 2
    assert first["losses"] == second["losses"]
    assert torch.equal(first["generator"], second["generator"])
    for key, value in first["states"][-1].items():
        assert torch.equal(value, second["states"][-1][key]), key
    for got, want in zip(first["preds"], second["preds"]):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("step", [0, 1])
def test_two_ranks_equal_one_process_with_dropout(dropout_runs, step):
    """Losses and the global batch's logits of each step within rtol 1e-5,
    and the state after the first step within rtol 1e-3 / atol 1e-4 (the
    tight tier of tests/test_torch_port_train_step.py): the dropout and
    MHA-dropout masks are the one process's draws (a rank's own draws at
    rate 0.5 would move the losses by percent), and the generator ends in
    the one process's state."""
    ranks, one = dropout_runs
    got, want = ranks[0], one
    assert want["world"] == 1
    for key, value in want["losses"][step].items():
        np.testing.assert_allclose(got["losses"][step][key], value, rtol=1e-5, err_msg=key)
    for key in ("verb", "noun"):
        np.testing.assert_allclose(got["preds"][step][key], want["preds"][step][key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert torch.equal(got["generator"], want["generator"])
    if step == 0:
        assert set(got["states"][0]) == set(want["states"][0])
        for key, value in want["states"][0].items():
            np.testing.assert_allclose(got["states"][0][key].numpy(), value.numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=key)

"""Ranks of the port on the CPU for the tests: ``run_ranks`` spawns ``world``
processes (``torch.multiprocessing``, gloo on a free localhost port, the
variables ``torchrun`` sets), runs one of this module's cases in each and
returns what each rank returned. The ranks import torch and the port only:
this module imports nothing of JAX, which stays in the test process."""

import hashlib
import os
import socket
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

from attention_based_tbn_tpu_torch.parallel import mesh


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def torchrun_env(rank: int, world: int, port: int) -> dict:
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": str(rank),
            "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}


def _entry(rank, world, port, case, args, out_dir):
    os.environ.update(torchrun_env(rank, world, port))
    torch.set_num_threads(1)
    try:
        mesh.make_mesh(None, "cpu")  # gloo; main's own make_mesh finds it made
        result = CASES[case](*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


def run_ranks(case: str, world: int, *args) -> list:
    """``CASES[case](*args)`` in each of ``world`` spawned ranks; their
    results in rank order. A failing rank fails the call; only a port that
    another process took between ``free_port`` and rank 0's bind is tried
    again, on a new port."""
    for attempt in range(3):
        with tempfile.TemporaryDirectory() as out_dir:
            try:
                mp.start_processes(_entry, args=(world, free_port(), case, args, out_dir),
                                   nprocs=world, join=True, start_method="spawn")
            except mp.ProcessRaisedException as exc:
                if "EADDRINUSE" in str(exc) and attempt < 2:
                    continue
                raise
            return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]


def state_hash(state_dict) -> str:
    """sha256 over a state dict's tensors in key order."""
    digest = hashlib.sha256()
    for key in sorted(state_dict):
        digest.update(key.encode())
        digest.update(state_dict[key].detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


# --- cases --------------------------------------------------------------


def bn_inputs(seed: int, rows: int = 8, channels: int = 4, hw: int = 3):
    """The global batch of the BatchNorm case: x, an upstream gradient,
    gamma, beta, running mean and variance, the conv bias offset."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(rows, channels, hw, hw) * 2 + 0.5, "g": f(rows, channels, hw, hw),
            "gamma": f(channels) * 0.2 + 1, "beta": f(channels) * 0.1,
            "mean": f(channels) * 0.1, "var": np.abs(f(channels)) + 0.5,
            "offset": f(channels) * 0.1}


def batch_norm_case(seed: int, true_rows):
    """``layers.batch_norm_train`` on this rank's rows of ``bn_inputs``
    (``true_rows`` of the global batch real, None: all): output, input
    gradient, gamma / beta gradients (this rank's share), running stats."""
    from attention_based_tbn_tpu_torch.models.layers import batch_norm_train

    data = bn_inputs(seed)
    world, rank = mesh.world_size(), mesh.rank()
    rows = data["x"].shape[0] // world
    own = slice(rank * rows, (rank + 1) * rows)
    bn = torch.nn.BatchNorm2d(data["x"].shape[1])
    with torch.no_grad():
        for name, key in (("weight", "gamma"), ("bias", "beta"), ("running_mean", "mean"),
                          ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(data[key]))
    x = torch.from_numpy(data["x"][own]).requires_grad_(True)
    y = batch_norm_train(x, bn, torch.from_numpy(data["offset"]),
                         mesh.row_mask(rows, true_rows, x.device))
    (y * torch.from_numpy(data["g"][own])).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dgamma": bn.weight.grad, "dbeta": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def train_steps_case(overrides, model_state, steps):
    """The port's train step over ``steps`` [(global batch, targets,
    true_bs)], each rank on its contiguous rows of every global batch, from
    ``model_state``: per step the losses (global), the predictions (the
    global batch's) and the state dict; at the end the generator's state
    and the world."""
    from attention_based_tbn_tpu_torch.config import load_config
    from attention_based_tbn_tpu_torch.models.builder import build_model
    from attention_based_tbn_tpu_torch.parallel.train_step import (create_train_state,
                                                                   make_train_step)
    from attention_based_tbn_tpu_torch.utils.misc import get_modality

    cfg = load_config(overrides=list(overrides))
    model = build_model(cfg, get_modality(cfg), device="cpu")
    model.load_state_dict(model_state)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    world, rank = mesh.world_size(), mesh.rank()
    losses, preds, states = [], [], []
    for batch, targets, true_bs in steps:
        def local(x):
            rows = x.shape[0] // world
            return x[rank * rows:(rank + 1) * rows]
        batch = {k: local(v) for k, v in batch.items()}
        targets = {"class": {k: local(v) for k, v in targets["class"].items()}}
        state, loss, out = step(state, batch, targets, 0, true_bs)
        losses.append({k: float(v) for k, v in loss.items()})
        preds.append({k: v.float().numpy() for k, v in out.items()})
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return {"losses": losses, "preds": preds, "states": states, "world": world,
            "generator": state.generator.get_state()}


def train_sequences_case(overrides, model_state, sequences):
    """:func:`train_steps_case` once per sequence of steps, each from
    ``model_state``."""
    return [train_steps_case(overrides, model_state, steps) for steps in sequences]


def main_case(argv_runs):
    """The port's ``main`` once per argv of ``argv_runs`` on this rank;
    returns per run main's result, the trainer's final state (its hash;
    on rank 0 the state itself and the hash of the checkpoint read back)
    and the files this rank wrote (checkpoints, histories, challenge
    JSONs)."""
    from attention_based_tbn_tpu_torch import main as port_main
    from attention_based_tbn_tpu_torch.config import load_config
    from attention_based_tbn_tpu_torch.utils.misc import get_modality
    from attention_based_tbn_tpu_torch.tools import test as port_test
    from attention_based_tbn_tpu_torch.tools import train as port_train
    from attention_based_tbn_tpu_torch.utils import checkpoint

    writes = []
    states = []
    write_replacing, save_scores = checkpoint._write_replacing, port_test.save_scores
    run_trainer = port_train.run_trainer

    def counted_write(path, *args):
        writes.append(os.path.basename(path))
        return write_replacing(path, *args)

    def counted_scores(output, path, *args):
        writes.append(os.path.basename(path))
        return save_scores(output, path, *args)

    def kept_trainer(*args, **kwargs):
        states.append(run_trainer(*args, **kwargs))
        return states[-1]

    checkpoint._write_replacing, port_test.save_scores = counted_write, counted_scores
    port_train.run_trainer = kept_trainer
    runs = []
    try:
        for argv in argv_runs:
            del writes[:], states[:]
            results = port_main.main(list(argv))
            run = {"results": results, "writes": list(writes), "world": mesh.world_size()}
            if states:
                sd = {k: v.detach().clone() for k, v in states[-1].model.state_dict().items()}
                run["hash"] = state_hash(sd)
                run["generator"] = states[-1].generator.get_state()
                run["step"] = states[-1].step
                if mesh.is_primary():
                    run["state"] = sd
                    cfg = load_config(overrides=list(argv))
                    path = port_train.checkpoint_stem(cfg, get_modality(cfg)) + ".pth"
                    run["file_hash"] = state_hash(checkpoint.read_state_dict(path))
            runs.append(run)
    finally:
        checkpoint._write_replacing, port_test.save_scores = write_replacing, save_scores
        port_train.run_trainer = run_trainer
    return runs


CASES = {"batch_norm": batch_norm_case, "train_steps": train_steps_case,
         "train_sequences": train_sequences_case, "main": main_case}

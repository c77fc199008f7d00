"""Training through ``parallel/train_step.make_train_step``, one process.

Set-up builds one train state (the model with the seeded weights, its
optimizer, the noise generator), makes ``distinct_batches`` seeded global
batches of ``clips_per_step`` clips x ``segments`` segments on the card,
and drives the state through its first ``checked_steps`` steps, each on
its own batch, through the window's own call: those steps are the warm-up
and what the reference follows. The window then runs steps on the same
state, cycling the batches, each step ended by a synchronize, until
``--seconds`` have passed; the rate is the window's clips over its time.

A traced run times the host's part of each step (the call until it
returns, before the synchronize), then profiles ``traced_steps`` steps.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from portbench.costs import flops, kernels
from portbench.harness import checks, device as dev, seeded
from portbench.harness import trace as tracing
from portbench.reference import tbn, train as ref_train
from portbench.reference.precision import FLOAT32, Precision

# the leaves whose whole first gradient is compared: Fusion's and the
# heads', which BatchNorm does not amplify
HEAD_LEAVES = ("fusion.", "classifier.")


def global_batches(desc: dict, mix: dict, seed: int, device, count: int):
    """The first ``count`` seeded global batches: (clips, labels)."""
    gen = seeded.generator(seed, "inputs", device)
    out = []
    for _ in range(count):
        clips = seeded.clips(desc, mix["clips_per_step"], mix["segments"], gen, device)
        out.append((clips, seeded.labels(desc, mix["clips_per_step"], gen, device)))
    return out


def reference_run(run, host_params: Dict[str, torch.Tensor], prec: Precision = FLOAT32) -> dict:
    """The reference's first ``checked_steps`` steps from the same weights,
    batches and noise seed: losses, first gradient norms, the heads' first
    gradients, change norms (``prec``: the control's rounding)."""
    device, mix = run.device, run.traffic
    params = {k: v.to(device) for k, v in host_params.items()}
    noise = seeded.generator(run.seed, "noise", device)
    trainer = ref_train.Trainer(params, run.desc, run.config["train"], noise, prec)
    del params
    losses, logits = [], []
    with dev.exact_float32():
        for clips, labels in global_batches(run.desc, mix, run.seed, device,
                                            mix["checked_steps"]):
            loss, out = trainer.step(clips, labels)
            losses.append(loss["total"])
            logits.append({k: v.float().cpu().numpy() for k, v in out.items()})
    grads = {k: float(v.norm()) for k, v in trainer.first_grads.items()}
    head_grads = {k: v.cpu() for k, v in trainer.first_grads.items() if k.startswith(HEAD_LEAVES)}
    change = {k: float((trainer.params[k].cpu() - host_params[k]).norm())
              for k in changed_leaves(trainer.names, trainer.spec)}
    return {"losses": losses, "logits": logits, "grad_norms": grads, "head_grads": head_grads,
            "change_norms": change}


def changed_leaves(trainable, spec: dict):
    """The trainable parameters and the BatchNorm running statistics."""
    return list(trainable) + [k for k, (_, kind, _) in spec.items()
                              if kind in ("bn_mean", "bn_var")]


def loop(run) -> dict:
    """Set-up, the checked steps, the window and (traced) the profiled
    steps. Returns the record, with ``port`` (what the reference is held
    to) and the initial weights on the host."""
    from attention_based_tbn_tpu_torch.models.builder import build_model
    from attention_based_tbn_tpu_torch.parallel.optim import lr_at_epoch
    from attention_based_tbn_tpu_torch.parallel.train_step import (create_train_state,
                                                                   make_train_step)

    phases = dev.Phases(run.started)
    mix, desc, device = run.traffic, run.desc, run.device
    clips_per_step = mix["clips_per_step"]
    cfg = run.port_config([f"train.num_segments={mix['segments']}",
                           f"train.batch_size={clips_per_step}"])
    phases.mark("imports")
    dev.build_kernels(device, run.config["kernels"]["train"])
    phases.mark("kernel builds")
    params = seeded.make_params(desc, run.seed, device)
    model = build_model(cfg, list(desc["modality"]), device)
    model.load_state_dict(params, strict=True)
    host_params = {k: v.cpu() for k, v in params.items()}
    del params
    state = create_train_state(cfg, model, seed=seeded.stream_seed(run.seed, "noise"))
    state.optimizer.set_learning_rate(lr_at_epoch(cfg, 0))
    phases.mark("model and optimizer")
    batches = global_batches(desc, mix, run.seed, device, mix["distinct_batches"])
    names = {id(p): n for n, p in model.named_parameters()}
    step = make_train_step(cfg)
    dev.release(device)
    dev.reset_peak(device)
    phases.mark("batches")

    def one(i: int):
        clips, labels = batches[i % len(batches)]
        began = time.perf_counter()
        with torch.profiler.record_function(tracing.LABELS[1]):
            _, loss, preds = step(state, clips, {"class": labels}, 0, clips_per_step)
        returned = time.perf_counter()
        with torch.profiler.record_function(tracing.LABELS[2]):
            dev.sync(device)
        return (loss, preds), began, returned, time.perf_counter()

    losses, logits, grad_norms, head_grads = [], [], {}, {}
    for i in range(mix["checked_steps"]):
        loss, preds = one(i)[0]
        losses.append(float(loss["total"]))
        logits.append({k: preds[k].float().cpu().numpy() for k in desc["num_classes"]})
        if i == 0:
            # the clipped gradient the optimizer took: its momentum after one step
            momentum = state.optimizer.inner.state
            firsts = {names[id(p)]: momentum[p]["momentum_buffer"].detach().float()
                      if "momentum_buffer" in momentum.get(p, {}) else torch.zeros_like(p)
                      for p in state.optimizer.trainable}
            grad_norms = {k: float(v.norm()) for k, v in firsts.items()}
            head_grads = {k: v.to("cpu", copy=True) for k, v in firsts.items()
                          if k.startswith(HEAD_LEAVES)}
            del firsts
    current = dict(model.state_dict())
    change = {k: float((current[k].detach().cpu().float() - host_params[k]).norm())
              for k in changed_leaves(grad_norms, tbn.param_spec(desc))}
    del current
    phases.mark("checked steps")
    setup_s = run.since_start()

    i, steps, host_s = mix["checked_steps"], [], []
    start = time.perf_counter()
    while True:
        _, began, returned, ended = one(i)
        steps.append(ended - began)
        host_s.append(returned - began)
        i += 1
        if ended - start >= run.seconds:
            break
    window_s = ended - start
    record = {"setup_s": setup_s, "setup_phases": phases.seconds, "window_s": window_s,
              "chips": run.chips,
              "attempted": len(steps), "failed": 0,
              "clips": clips_per_step * len(steps), "steps": len(steps),
              "step_host_s": host_s, "step_s": steps}
    if run.trace:
        traced = mix["traced_steps"]
        record["trace"] = tracing.profile(lambda: [one(i + k) for k in range(traced)], device)
        record["items_traced"] = traced
        shapes = flops.model_shapes(desc, clips_per_step, mix["segments"])
        record["work_least_s"] = kernels.work(run.config["kernels"]["train"], shapes, train=True)
        record["flops_per_clip"] = flops.flops_per_clip(desc, mix["segments"], train=True,
                                                        recipe=run.config["train"])
    record["peak_bytes"] = dev.peak_bytes(device)
    record["device_kind"] = dev.kind(device)
    record["port"] = {"losses": losses, "logits": logits, "grad_norms": grad_norms,
                      "head_grads": head_grads, "change_norms": change}
    record["host_params"] = host_params
    del state, model, batches, step
    dev.release(device)
    return record


def judge_against_reference(run, record: dict) -> None:
    """Run the reference and put the compared numbers in the record."""
    want = reference_run(run, record["host_params"])
    record["reference"] = want
    numbers, leaves = checks.train_numbers(record["port"], want)
    record["numbers"], record["worst_leaves"] = numbers, leaves


def run(run) -> dict:
    record = loop(run)
    judge_against_reference(run, record)
    return record


def control_numbers(run, record: dict, prec: Precision) -> dict:
    """The reference in ``prec`` put in the program's place: its numbers
    against the float32 reference of the run."""
    got = reference_run(run, record["host_params"], prec)
    return checks.train_numbers(got, record["reference"])[0]

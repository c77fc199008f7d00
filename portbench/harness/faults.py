"""Faults planted under the timed path, to show that ``correct`` catches
them (the tests) and to read how far each moves the compared numbers (the
calibration): a step that leaves the state as it was; half of each batch
left out of the loss, the means taken over the rest, while the step still
returns every row (``half_batch``); half of each batch's rows cut before
the step (``half_batch_rows``); a served answer altered where it is
produced."""

from __future__ import annotations

import contextlib
from typing import Iterator

FAULTS = ("unchanged_state", "half_batch", "half_batch_rows", "altered_answer")


def _half(t):
    return t[: t.shape[0] // 2]


@contextlib.contextmanager
def planted(fault: str) -> Iterator[None]:
    from attention_based_tbn_tpu_torch.parallel import optim, train_step
    from attention_based_tbn_tpu_torch.tools import serve

    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == "unchanged_state":
        def step(self):
            self._model.zero_grad(set_to_none=True)
            return False
        patch(optim.Optimizer, "step", step)
    elif fault == "half_batch":
        loss = train_step.tbn_loss

        def half_loss(preds, targets, cfg, **kw):
            rows = _half(next(iter(targets["class"].values()))).shape[0]
            labels = targets["class"]
            preds = {k: v[:rows] if k in labels else v for k, v in preds.items()}
            return loss(preds, dict(targets, **{"class": {k: v[:rows] for k, v in labels.items()}}),
                        cfg, **kw)
        patch(train_step, "tbn_loss", half_loss)
    elif fault == "half_batch_rows":
        make = train_step.make_train_step

        def make_halved(cfg):
            inner = make(cfg)

            def halved(state, batch, targets, epoch, true_bs):
                batch = {k: _half(v) for k, v in batch.items()}
                targets = {"class": {k: _half(v) for k, v in targets["class"].items()}}
                return inner(state, batch, targets, epoch, true_bs // 2)
            return halved
        patch(train_step, "make_train_step", make_halved)
    else:
        run = serve.ServingModel._run

        def altered(self, bucket, tensors):
            out = run(self, bucket, tensors)
            head = next(iter(out))
            out[head] = out[head].clone()
            out[head][0] += out[head][0].abs().mean()
            return out
        patch(serve.ServingModel, "_run", altered)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)

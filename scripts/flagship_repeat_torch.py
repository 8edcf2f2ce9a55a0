"""Repeat the flagship's bf16 train loop on the card from the same seeded
weights and report the first step whose loss or gradients are not finite.

Usage:
  python scripts/flagship_repeat_torch.py [--runs 4] [--steps 13] \
      [--overflow] [--root DIR] [--json OUT]

Each run builds ``flagship.build_flagship_train()`` (groomed_nms, batch 8,
512x1760, bf16 autocast, seed 0) and takes ``--steps`` steps on its one
batch, as the smoke run's phase 11 (b) does (3 warm-up + 10 timed steps),
under the flags that phase runs with: cuDNN autotuning on, TF32 on for
convolutions and off for matmuls.  After each step the loss and every
gradient are checked.  At the first step with a non-finite one, the step is
taken again from a copy of the state made before it, under
``torch.autograd.detect_anomaly`` and with a forward hook on every leaf
module: the first module whose forward output is not finite and the first
backward op that returns NaN (with the forward line that made it) are
reported.  cuDNN picks its algorithms once a process, so the runs of one
process share them.

``--overflow`` sets the head's bias of anchor 0's 2D dw channel to 100
before the first step, so that every row of that anchor decodes to a box
whose ``exp`` overflows f32: the loss's backward must stay finite all the
same (``losses/rpn_3d.py::MAX_LOG_SCALE``).

``--root`` imports ``groomed_nms_torch`` from another checkout, so two trees
can be compared on one card in turns.  Prints the card's name and power
limit, one line a run and, last, a JSON summary (also written to
``--json``).
"""

import argparse
import copy
import json
import os
import subprocess
import sys
import time
import warnings

_HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.abspath(sys.path[0]) == _HERE:     # scripts/profile.py shadows
    sys.path.pop(0)                             # the standard library's


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=13)
    ap.add_argument("--overflow", action="store_true",
                    help="anchor 0's 2D dw bias at 100 (exp overflows)")
    ap.add_argument("--root", default=os.path.dirname(_HERE),
                    help="the checkout whose groomed_nms_torch runs")
    ap.add_argument("--json", default=None)
    return ap.parse_args(argv)


def nonfinite_grads(model):
    """Names of the parameters whose gradient holds a NaN or an inf."""
    import torch

    named = [(n, p.grad) for n, p in model.named_parameters()
             if p.grad is not None]
    ok = torch.stack([torch.isfinite(g).all() for _, g in named]).cpu()
    return [n for (n, _), good in zip(named, ok.tolist()) if not good]


def diagnose(step, state, batch):
    """The step again on ``state`` (a copy made before it) with forward
    hooks and anomaly detection: (first leaf module with a non-finite
    output, the anomaly error, the tail of its forward traceback)."""
    import torch

    first = []

    def hook(name):
        def check(_module, _inputs, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if not first and any(torch.is_tensor(o) and o.is_floating_point()
                                 and not torch.isfinite(o).all()
                                 for o in outs):
                first.append(name)
        return check

    handles = [m.register_forward_hook(hook(n))
               for n, m in state.model.named_modules()
               if not list(m.children())]
    error, trace = None, None
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with torch.autograd.detect_anomaly(check_nan=True):
                step(state, batch)
        for w in caught:
            text = str(w.message)
            if "Traceback of forward call" in text:
                trace = text.strip().splitlines()[-12:]
    except RuntimeError as e:
        error = str(e).splitlines()[0]
        for w in caught:
            text = str(w.message)
            if "Traceback of forward call" in text:
                trace = text.strip().splitlines()[-12:]
    finally:
        for h in handles:
            h.remove()
    return (first[0] if first else None), error, trace


def one_run(build, steps, overflow=False):
    """A fresh flagship state and ``steps`` steps (with ``overflow``, anchor
    0's 2D dw bias at 100 first): the losses and, at the first non-finite
    step, what ``diagnose`` finds."""
    import torch

    step, state, batch = build(device="cuda")
    if overflow:
        with torch.no_grad():
            state.model.head.bias[state.model.config.num_classes + 2] = 100.0
    losses = []
    for i in range(steps):
        before = copy.deepcopy(state)
        stats = step(state, batch)
        loss = float(stats["total"])
        losses.append(loss)
        bad_stats = [k for k, v in stats.items()
                     if not torch.isfinite(v).all()]
        bad_grads = nonfinite_grads(state.model)
        if bad_stats or bad_grads:
            module, error, trace = diagnose(step, before, batch)
            return dict(losses=losses, first_bad_step=i,
                        nonfinite_stats=bad_stats,
                        nonfinite_grads=bad_grads[:8],
                        n_nonfinite_grads=len(bad_grads),
                        first_nonfinite_module=module,
                        anomaly=error, forward_trace=trace)
        del before
    return dict(losses=losses, first_bad_step=None)


def main(argv=None):
    args = parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from groomed_nms_torch.flagship import build_flagship_train

    if not torch.cuda.is_available():
        raise RuntimeError("flagship_repeat_torch.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    import groomed_nms_torch
    tree = os.path.dirname(os.path.dirname(groomed_nms_torch.__file__))
    runs = []
    for r in range(args.runs):
        t = time.perf_counter()
        out = one_run(build_flagship_train, args.steps, args.overflow)
        out["seconds"] = time.perf_counter() - t
        runs.append(out)
        print(f"run {r} ({tree}{', overflow' if args.overflow else ''}): "
              f"first non-finite step "
              f"{out['first_bad_step']}, losses "
              f"{[round(x, 4) for x in out['losses']]}"
              + (f"; non-finite stats {out['nonfinite_stats']}, grads "
                 f"{out['n_nonfinite_grads']} (first {out['nonfinite_grads']}"
                 f"), first non-finite module output "
                 f"{out['first_nonfinite_module']}, anomaly {out['anomaly']}"
                 if out["first_bad_step"] is not None else "")
              + f"; {out['seconds']:.1f} s [{card}]", flush=True)
    summary = {"tree": tree, "card": card, "overflow": args.overflow,
               "runs": runs,
               "nonfinite_runs": sum(r["first_bad_step"] is not None
                                     for r in runs)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f)
    print(json.dumps({"tree": tree, "overflow": args.overflow,
                      "runs": len(runs),
                      "nonfinite_runs": summary["nonfinite_runs"]}))


if __name__ == "__main__":
    main()

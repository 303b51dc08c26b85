"""Whether what the timed path produced is correct: the reference's
judgement of the first training steps and the validation of the warm-up
epoch, which went through the window's own entry on the window's own
object, at the window's sizes.

The reference follows the steps from the harness's weights, on the
harness's inputs: it builds each step's QUBOs again and compares them
with the program's; it takes the program's samples (the sampler's output,
read here only to judge it) and works out the moments, the update and
the loss again; it compares the first gradient (the program's: its
parameters' change over the step ÷ lr) and the parameters' change after
the steps, leaf by leaf.  The warm-up epoch's last step, whose batch is
the epoch's partial one (its padding rows masked), is judged the same
way from the program's parameters before it.  The sampler stage itself is judged apart: the
reference anneals the same QUBOs with its own random numbers, and the
mean energy of the program's samples must agree with the reference's
within the sampling noise.  The validation call is judged the same way,
from the program's parameters at that point (the reference does not
follow the whole epoch), and its predictions are worked out again from
the program's samples.

Numbers, each the worst over steps, phases, seeds or leaves:
``qubo_gap`` (linear terms and couplings, relative to the largest),
``loss_gap`` (relative to the larger of the seed's loss and the median
seed's), ``grad_gap`` and ``change_gap`` (the gap of the
norms of a leaf past what storing its parameters in float32 may move it
by, relative to the larger of the reference's leaf norm and its median
moving leaf's; the first gradient over the leaves at or above that
median, the change after the first steps and over the last step over
every leaf but those the reference's gradient moves by round-off alone),
``sample_z`` (the energy gap in standard errors, over the real rows) and
``predict_gap`` (the number of predictions that differ, or the largest
probability gap).
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from benchmark import data as bdata
from benchmark import registry
from benchmark.reference.anneal import anneal, energies, symmetric
from benchmark.reference.precision import FP32, TF32, Precision, no_tf32

#: the training steps the reference follows
CHECK_STEPS = 3
NUMBERS = ("qubo_gap", "loss_gap", "grad_gap", "change_gap", "sample_z", "predict_gap")
PHASES = ("clamped", "unclamped")


def phases_of(call: dict, free: dict, names, device) -> dict:
    """A sampler call of the program, phase-major groups (every seed's
    clamped group, then every seed's unclamped one) as ``{phase: (h (S, B,
    n), U (S, n, n), s (S, B, R, n), pad)}`` over the phase's free units;
    ``pad`` is the largest coupling to a unit past them (none may couple)."""
    Q = call["Q"].to(device, torch.float32)
    hx = call["h"].to(device, torch.float32)
    s = call["s"].to(device, torch.float32)
    S = Q.shape[0] // len(names)
    h_eff = torch.diagonal(Q, dim1=-2, dim2=-1)[:, None, :] + hx
    U = torch.triu(Q, 1) + torch.triu(Q.transpose(-1, -2), 1)
    out = {}
    for i, name in enumerate(names):
        g, n = slice(i * S, (i + 1) * S), free[name]
        past = torch.cat([U[g, :, n:].flatten(), U[g, n:, :].flatten(), U.new_zeros(1)])
        out[name] = (h_eff[g, :, :n], U[g, :n, :n], s[g, :, :, :n], float(past.abs().max()))
    return out


def raw_call(phases: dict, names) -> dict:
    """The program's call format of ``{phase: (h, U, s)}``: couplings with
    a zero diagonal, the linear terms as per-problem extras, every phase
    padded to the widest."""
    n = max(phases[k][0].shape[-1] for k in names)
    Q, H, S = [], [], []
    for k in names:
        h, U, s = phases[k]
        m = h.shape[-1]
        Q.append(torch.nn.functional.pad(U, (0, n - m, 0, n - m)))
        H.append(torch.nn.functional.pad(h, (0, n - m)))
        S.append(torch.nn.functional.pad(s, (0, n - m)))
    return {"Q": torch.cat(Q).cpu(), "h": torch.cat(H).cpu(), "s": torch.cat(S).to(torch.uint8).cpu()}


def _rel(a: torch.Tensor, b: torch.Tensor, extra: float = 0.0) -> float:
    scale = float(b.abs().max()) if b.numel() else 0.0
    gap = max(float((a - b).abs().max()) if a.numel() else 0.0, extra)
    return gap / (scale if scale > 0 else 1.0)


def energy_z(h, U, s_prog, s_ref) -> float:
    """The gap of the mean energies of two sets of samples of the same
    problems, in standard errors of the gap (per-problem variances over
    the reads)."""
    J = symmetric(U)
    Ep, Er = energies(h, J, s_prog), energies(h, J, s_ref)
    R = Ep.shape[-1]
    diff = float((Ep.mean(-1) - Er.mean(-1)).sum())
    var = float(((Ep.var(-1) + Er.var(-1)) / R).sum())
    if var <= 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return abs(diff) / math.sqrt(var)


def _leaf_norms(d: dict) -> torch.Tensor:
    """The norm of every (seed, parameter) leaf, as one vector."""
    return torch.cat([v.reshape(v.shape[0], -1).double().norm(dim=1) for v in d.values()])


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at each entry's magnitude."""
    x = x.float().abs()
    return torch.nextafter(x, torch.full_like(x, math.inf)) - x


def rounding(before: dict, after: dict, steps: int) -> torch.Tensor:
    """Each leaf's norm of what storing its parameters in float32 may move
    a change over ``steps`` steps by, on the two sides together: half a
    spacing a side a step, at the larger magnitude of the leaf's entries
    before and after."""
    return steps * _leaf_norms({n: _ulp(torch.maximum(before[n].abs(), after[n].abs()))
                                for n in before})


def _median(v: torch.Tensor) -> float:
    """The median of the nonzero entries (0 where there are none): the
    median leaf among those the reference moves, since a model may leave a
    block all but dead on some rows and its gradient exactly 0."""
    v = v[v > 0].cpu().numpy()
    return float(np.median(v)) if v.size else 0.0


def _norm_gap(prog: torch.Tensor, ref: torch.Tensor, keep=None, allow=None) -> float:
    """The worst leaf's gap of norms past ``allow`` (the float32 rounding
    of its parameters), each against the larger of the reference's norm
    of that leaf and of the median moving leaf."""
    floor = _median(ref) or 1e-30
    gap = (prog - ref).abs()
    if allow is not None:
        gap = (gap - allow).clamp_min(0.0)
    if keep is not None:
        gap, ref = gap[keep], ref[keep]
    if not ref.numel():
        return 0.0
    return float((gap / ref.clamp_min(floor)).max())


def _kept(grad: torch.Tensor) -> torch.Tensor:
    """The leaves a change is judged on: all but those the reference's
    gradient moves by round-off alone (under a thousandth of the median
    moving leaf's); one it leaves exactly stays in (the program may not
    move it either)."""
    return (grad >= 1e-3 * _median(grad)) | (grad == 0)


def record_steps(data: dict, t: dict) -> tuple:
    """The indices of the warm-up's steps the check judges: the first
    ``CHECK_STEPS`` and the last, whose batch is the epoch's partial one."""
    rows = len(bdata.splits(data, t)["warm"][0])
    last = -(-rows // t["batch"]) - 1
    return tuple(sorted(set(range(min(CHECK_STEPS, last + 1))) | {last}))


class Judge:
    def __init__(self, cfg: dict, mix: dict, data: dict, weights: dict, seed: int, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.model, self.t = cfg["model"], registry.settings(cfg, mix)
        self.ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
        self.free = self.ref.free_units(self.model)
        # the rows the warm-up trained on: its last batch is partial even where the
        # full split's batch there is whole
        self.train = bdata.splits(data, self.t)["warm"][:2]
        self.w0 = {k: v.to(device) for k, v in weights.items()}
        self.gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED5EED)
        S = next(iter(weights.values())).shape[0]
        k = min(mix.get("judge_seeds", S), S)
        self.jobs: list = []
        self.detail: dict = {}
        self.judged = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(S, k, replace=False)),
                                      device=device)
        self.indices = record_steps(data, self.t)

    # -- inputs ---------------------------------------------------------------

    def _rows(self, k: int):
        B = self.t["batch"]
        x = torch.as_tensor(self.train[0][k * B:(k + 1) * B], device=self.device)
        y = torch.as_tensor(self.train[1][k * B:(k + 1) * B], device=self.device)
        mask = torch.ones(B, device=self.device)
        if x.shape[0] < B:
            pad = B - x.shape[0]
            mask[x.shape[0]:] = 0.0
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            y = torch.nn.functional.pad(y, (0, pad))
        return x, y, mask

    def _val_chunks(self, vx: np.ndarray):
        """The validation's chunks, each zero-padded to the chunk, with its
        number of real rows."""
        chunk = self.t.get("predict_chunk") or len(vx)
        for i in range(0, len(vx), chunk):
            x = torch.as_tensor(vx[i:i + chunk], device=self.device)
            yield torch.nn.functional.pad(x, (0, 0, 0, chunk - x.shape[0])), x.shape[0]

    def _anneal(self, h, U, prec: Precision = FP32):
        return anneal(self.mix["solver"], h, U, self.t["sample_count"], self.t["anneal"],
                      self.gen, rungs=self.mix.get("rungs", 1), prec=prec)

    # -- the judgement ----------------------------------------------------------

    def numbers(self, rec: dict, val_X: np.ndarray) -> dict:
        no_tf32()
        num = {k: 0.0 for k in NUMBERS}
        steps = rec["steps"]
        if ([st.get("index") for st in steps] != list(self.indices)
                or any(len(st["calls"]) != 1 for st in steps)):
            return {**num, "qubo_gap": math.inf}  # a step, or a step's one sampler call, missing
        dev = self.device
        p = self.w0
        grads = []
        head = steps[:CHECK_STEPS]
        for st in head:
            grad, p_next = self._judge_step(num, st, p)
            if st["index"] == 0:
                # the program's gradient as its update took it, (p0 - p1) / lr; float32
                # cancellation blurs it where lr·g is small against p, so it is compared
                # past the rounding of p, on the leaves at or above the median moving leaf
                before = {n: st["before"][n].to(dev) for n in grad}
                after = {n: st["after"][n].to(dev) for n in grad}
                g_prog = _leaf_norms({n: (before[n] - after[n]) / st["lr"] for n in grad})
                g_ref = _leaf_norms(grad)
                num["grad_gap"] = _norm_gap(g_prog, g_ref, g_ref >= _median(g_ref),
                                            rounding(before, after, 1) / st["lr"])
                first = {"grad1_prog": g_prog.tolist(), "grad1_ref": g_ref.tolist()}
            grads.append(_leaf_norms(grad))
            p = p_next
        keep = _kept(torch.stack(grads).max(0).values)
        last = {n: v.to(dev) for n, v in head[-1]["after"].items()}
        d_prog = _leaf_norms({n: last[n] - self.w0[n] for n in p})
        d_ref = _leaf_norms({n: p[n] - self.w0[n] for n in p})
        allow = rounding(self.w0, p, len(head))
        num["change_gap"] = _norm_gap(d_prog, d_ref, keep, allow)
        self.detail = {"leaves": [f"{n}[{i}]" for n in p for i in range(p[n].shape[0])],
                       "keep": keep.tolist(), "change_prog": d_prog.tolist(),
                       "change_ref": d_ref.tolist(), "change_allow": allow.tolist(), **first}
        for st in steps[CHECK_STEPS:]:
            # the warm-up's last step, from the program's own state before it (the
            # reference follows only the first steps): its QUBOs, loss and change
            before = {n: v.to(dev) for n, v in st["before"].items()}
            grad, p_next = self._judge_step(num, st, before)
            d_prog = _leaf_norms({n: st["after"][n].to(dev) - before[n] for n in grad})
            d_ref = _leaf_norms({n: p_next[n] - before[n] for n in grad})
            allow, keep = rounding(before, p_next, 1), _kept(_leaf_norms(grad))
            gap = _norm_gap(d_prog, d_ref, keep, allow)
            num["change_gap"] = max(num["change_gap"], gap)
            self.detail.update(last_gap=gap, last_keep=keep.tolist(), last_prog=d_prog.tolist(),
                               last_ref=d_ref.tolist(), last_allow=allow.tolist())
        self._judge_val(num, rec["val"], val_X)
        self._judge_samples(num)
        return num

    def _judge_step(self, num: dict, st: dict, p: dict):
        """A recorded step from parameters ``p``: its QUBOs, its loss from
        its own samples; ``(the reference's gradient, its parameters
        after)``."""
        ref, model, dev = self.ref, self.model, self.device
        x, y, mask = self._rows(st["index"])
        want = ref.step_problems(p, x, y, model)
        got = phases_of(st["calls"][0], self.free, PHASES, dev)
        self._judge_call(num, want, got, int(mask.sum()))
        grad, p_next, nll = ref.update(p, x, y, mask, st["lr"], got["clamped"][2],
                                       got["unclamped"][2], model)
        nll_p, nll_r = st["nll"].to(dev).double(), nll.double()
        floor = _median(nll_r.abs()) or 1e-30  # a seed's loss may be 0 where all its reads agree
        num["loss_gap"] = max(num["loss_gap"], float(
            ((nll_p - nll_r).abs() / nll_r.abs().clamp_min(floor)).max()))
        return grad, p_next

    def _judge_call(self, num: dict, want: dict, got: dict, rows: int) -> None:
        """The QUBO gaps of a call's first ``rows`` problems (the real
        ones; a padding row's samples count for nothing); its judged
        seeds' samples of them wait in ``self.jobs`` for one anneal of all
        of them."""
        j = self.judged
        for phase, (h_r, U_r) in want.items():
            h_p, U_p, s_p, pad = got[phase]
            h_p, h_r = h_p[:, :rows], h_r[:, :rows]
            num["qubo_gap"] = max(num["qubo_gap"], _rel(h_p, h_r), _rel(U_p, U_r, pad))
            self.jobs.append((h_r[j], U_r[j], s_p[j][:, :rows]))

    def _judge_samples(self, num: dict) -> None:
        """Anneal every waiting call's QUBOs at once (each padded to the
        widest and to the most problems; a padding unit couples to nothing
        and a padding problem is not read) and compare the energies."""
        if not self.jobs:
            return
        n = max(h.shape[-1] for h, _, _ in self.jobs)
        B = max(h.shape[1] for h, _, _ in self.jobs)
        F = torch.nn.functional
        h_all = torch.cat([F.pad(h, (0, n - h.shape[-1], 0, B - h.shape[1]))
                           for h, _, _ in self.jobs])
        U_all = torch.cat([F.pad(U, (0, n - U.shape[-1], 0, n - U.shape[-1]))
                           for _, U, _ in self.jobs])
        s_all = self._anneal(h_all, U_all)
        g = 0
        for h, U, s_p in self.jobs:
            k, b, m = h.shape
            s_r = s_all[g:g + k, :b, :, :m]
            num["sample_z"] = max(num["sample_z"], energy_z(h, U, s_p, s_r))
            g += k
        self.jobs = []

    def _judge_val(self, num: dict, val: dict, val_X: np.ndarray) -> None:
        ref, model, dev = self.ref, self.model, self.device
        chunks = list(self._val_chunks(val_X))
        if "params" not in val or len(val["calls"]) != len(chunks):
            num["qubo_gap"] = math.inf
            return
        pv = {k: v.to(dev) for k, v in val["params"].items()}
        samples = []
        for (x, rows), call in zip(chunks, val["calls"]):
            h_r, U_r = ref.predict_problems(pv, x, model)
            got = phases_of(call, self.free, ("unclamped",), dev)
            self._judge_call(num, {"unclamped": (h_r, U_r)}, got, rows)
            samples.append(got["unclamped"][2][:, :rows])
        preds, probs = ref.predictions(torch.cat(samples, dim=1), model)
        differ = float((preds.cpu().numpy() != val["preds"]).sum())
        gap = float(np.abs(probs.double().cpu().numpy() - val["probs"]).max())
        num["predict_gap"] = max(differ, gap)

    # -- the control: the reference in the program's place, one precision below --

    def control_recording(self, val_X: np.ndarray, prec: Precision = TF32) -> dict:
        """A recording of the check's steps and validation made by the
        reference itself at ``prec``, in the program's format: the first
        steps, then the warm-up's last step's rows from where they left
        it."""
        ref, model, lr = self.ref, self.model, self.t["learning_rate"]
        p = self.w0
        steps = []
        for k in self.indices:
            x, y, mask = self._rows(k)
            want = ref.step_problems(p, x, y, model, prec)
            s = {ph: self._anneal(*want[ph], prec=prec) for ph in PHASES}
            _, p_next, nll = ref.update(p, x, y, mask, lr, s["clamped"], s["unclamped"], model,
                                        prec)
            steps.append({"index": k, "before": p, "after": p_next, "nll": nll, "mask": mask,
                          "lr": lr,
                          "calls": [raw_call({ph: (*want[ph], s[ph]) for ph in PHASES}, PHASES)]})
            p = p_next
        calls, samples = [], []
        for x, rows in self._val_chunks(val_X):
            h, U = ref.predict_problems(p, x, model, prec)
            s = self._anneal(h, U, prec)
            calls.append(raw_call({"unclamped": (h, U, s)}, ("unclamped",)))
            samples.append(s[:, :rows])
        preds, probs = ref.predictions(torch.cat(samples, dim=1), model)
        return {"steps": steps, "val": {"params": p, "calls": calls,
                                        "preds": preds.cpu().numpy(),
                                        "probs": probs.double().cpu().numpy()}}


def verdict(numbers: dict, limits: dict) -> bool:
    """Correct iff every number is at or under its limit."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)

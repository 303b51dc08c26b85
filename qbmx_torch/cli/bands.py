"""The band settings (North-star check 3 for every route by which a kernel
trains): ``qbmx``'s committed references, and the port's sweeps held to them.

Each setting is one CLI command that both packages take alike (the port's
adds ``--device``), trained over the ten seeds :data:`SEEDS` as one
``--seed_sweep``.  ``qbmx``'s sweep of it, run by ``qbmx``'s own CLI on the
CPU, lives under ``out/bands/<setting>/qbmx/``: the per-seed
``*acc_per_epoch<s>.pkl`` and ``*auc_per_epoch<s>.pkl`` and a
``manifest.json`` (the exact command, ``jax.__version__``, the commit, the
wall seconds and the final epoch's mean and sd).  The card's machine has no
jax; these files are how it sees ``qbmx``.  The port's sweep of a setting
holds when ``seed_bands.compare`` finds it within the reference at the
Bonferroni width for all the settings' comparisons together
(:func:`z_all`); its control, the same sweep at a tenth of the learning
rate, must fail that rule.  ``chip_smoke.py``'s band phase runs both on the
card.

    python -m qbmx_torch.cli.bands reference flat_sa_h2        # rewrite qbmx's reference
    python -m qbmx_torch.cli.bands port flat_sa_h2 --device cpu --out build/bands

This module imports nothing of ``qbmx``: ``reference`` runs ``qbmx``'s CLI in
a child process with ``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from qbmx_torch.cli import seed_bands

SEEDS = tuple(range(10))
REPO = Path(__file__).resolve().parents[2]
ROOT = REPO / "out" / "bands"
CONTROL_DIV = 10  # the control trains at the setting's learning rate over this

_FLAT = ("--data_set", "synthetic", "-sc", "16", "--anneal", "20", "-b", "60", "-lr", "0.03")
_FLAT_H300 = ("--data_set", "synthetic", "-hn", "300", "-r", "False", "-b", "60", "-e", "2",
              "-lr", "0.03")
# the CDQBM (b) at the CLI's deterministic pooling (n = 41); at -lr 0.05 qbmx
# ends its 4 epochs near chance (acc 0.625 SA, 0.588 BMS): 0.3 is where it learns
_CDQBM_B = ("--data_set", "synthetic", "-sc", "16", "--anneal", "20", "-b", "20", "-e", "4",
            "-lr", "0.3", "--pool_select", "absmax", "--signed_input", "True")

# setting -> (CLI module, its arguments).  The module is ``<package>.cli.<module>``.
SETTINGS: dict[str, tuple[str, tuple[str, ...]]] = {
    "flat_sa_h2": ("qbm_main", _FLAT + ("-hn", "2", "-e", "4")),
    "flat_bms_h2": ("qbm_main", _FLAT + ("-hn", "2", "-e", "4", "--solver", "BMS")),
    "flat_pt_h2": ("qbm_main", _FLAT + ("-hn", "2", "-e", "4", "--solver", "PT")),
    "flat_sa_h8": ("qbm_main", _FLAT + ("-hn", "8", "-e", "4")),
    "flat_bms_h8": ("qbm_main", _FLAT + ("-hn", "8", "-e", "4", "--solver", "BMS")),
    "flat_pt_h8": ("qbm_main", _FLAT + ("-hn", "8", "-e", "4", "--solver", "PT")),
    "cdqbm_b_sa": ("cdqbm_main", _CDQBM_B),
    "cdqbm_b_bms": ("cdqbm_main", _CDQBM_B + ("--solver", "BMS")),
    "cdqbm_b_pt": ("cdqbm_main", _CDQBM_B + ("--solver", "PT")),
    "flat_sa_h300": ("qbm_main", _FLAT_H300 + ("-sc", "16", "--anneal", "20")),
    # PT costs about M = 8 times SA: cut to 8 reads of 10 sweeps to keep qbmx's
    # CPU reference under half an hour
    "flat_pt_h300": ("qbm_main", _FLAT_H300 + ("-sc", "8", "--anneal", "10", "--solver", "PT")),
    "flat_bms_h300": ("qbm_main", _FLAT_H300 + ("-sc", "16", "--anneal", "20", "--solver", "BMS")),
}


def argv(setting: str, *, lr_div: int = 1) -> list[str]:
    """The setting's CLI arguments with the sweep's seeds, its learning rate
    over ``lr_div``; no ``--save`` or ``--device``."""
    _, args = SETTINGS[setting]
    args = list(args)
    if lr_div != 1:
        i = args.index("-lr")
        args[i + 1] = repr(float(args[i + 1]) / lr_div)
    return args + ["--seed_sweep", *map(str, SEEDS)]


def epochs(setting: str) -> int:
    args = SETTINGS[setting][1]
    return int(args[args.index("-e") + 1])


def z_all(settings) -> tuple[int, float]:
    """``(k, z_k)``: the comparisons the settings make together (every
    epoch, accuracy and AUC) and their Bonferroni width."""
    k = sum(epochs(s) * len(seed_bands.METRICS) for s in settings)
    return k, seed_bands.bonferroni_z(k)


def reference_dir(setting: str, root=ROOT) -> Path:
    return Path(root) / setting / "qbmx"


def read_manifest(setting: str, root=ROOT) -> dict:
    return json.loads((reference_dir(setting, root) / "manifest.json").read_text())


def final_epoch(folder) -> dict:
    """The last epoch's mean and sample sd of accuracy and AUC across seeds."""
    bands = seed_bands.load_bands(folder)
    return {m: {"mean": float(bands[m][:, -1].mean()), "sd": float(bands[m][:, -1].std(ddof=1)),
                "epochs": int(bands[m].shape[1])} for m in seed_bands.METRICS}


def write_reference(setting: str, root=ROOT) -> dict:
    """Run ``qbmx``'s CLI for ``setting`` on the CPU into its reference
    folder, keep the per-seed acc/auc pickles only, and write the manifest
    beside them."""
    out = reference_dir(setting, root)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    module, _ = SETTINGS[setting]
    cmd = ["python", "-m", f"qbmx.cli.{module}", *argv(setting),
           "--save", os.path.relpath(out, REPO) + "/"]
    t0 = time.perf_counter()
    subprocess.run([sys.executable, *cmd[1:]], cwd=REPO, env=env, check=True)
    seconds = time.perf_counter() - t0
    for p in out.iterdir():
        keep = p.is_file() and p.suffix == ".pkl" and not p.name.startswith("combined") and (
            "acc_per_epoch" in p.name or "auc_per_epoch" in p.name)
        if not keep:
            shutil.rmtree(p) if p.is_dir() else p.unlink()
    jax_version = subprocess.run([sys.executable, "-c", "import jax; print(jax.__version__)"],
                                 env=env, capture_output=True, text=True, check=True).stdout.strip()
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                            text=True, check=True).stdout.strip()
    manifest = {"setting": setting, "command": cmd, "env": {"JAX_PLATFORMS": "cpu"},
                "jax_version": jax_version, "commit": commit, "wall_seconds": seconds,
                "cpu_count": os.cpu_count(), "final_epoch": final_epoch(out)}
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


def train_port(setting: str, save, *, device: str, lr_div: int = 1):
    """The port's sweep of ``setting`` through its CLI, in this process,
    into ``save``; returns the CLI's per-seed best ``(accs, aucs)``."""
    module, _ = SETTINGS[setting]
    cli = importlib.import_module(f"qbmx_torch.cli.{module}")
    return cli.run(argv(setting, lr_div=lr_div) + ["--device", device, "--save", f"{save}/"])


def hold(setting: str, folder, z: float, root=ROOT) -> tuple[bool, list[dict]]:
    """``seed_bands.compare`` of a port sweep's folder against the reference."""
    return seed_bands.compare(seed_bands.load_bands(reference_dir(setting, root)),
                              seed_bands.load_bands(folder), z)


def widest(rows: list[dict]) -> dict:
    """The comparison whose difference of means takes the largest share of
    its half-width: ``{"epoch", "metric", "diff", "half_width"}``."""
    best = None
    for row in rows:
        for m in seed_bands.METRICS:
            c = row[m]
            diff = c["cand"][0] - c["ref"][0]
            share = abs(diff) / c["half_width"] if c["half_width"] else float("inf")
            if best is None or share > best[0]:
                best = (share, {"epoch": row["epoch"], "metric": m, "diff": diff,
                                "half_width": c["half_width"]})
    return best[1]


def means(rows: list[dict], who: str = "cand") -> dict:
    """Each metric's per-epoch (mean, min, max) of one side of the rows."""
    return {m: [tuple(row[m][who][:3]) for row in rows] for m in seed_bands.METRICS}


def run_port(settings, out, *, device: str, root=ROOT) -> dict:
    """Train each setting and its control with the port into ``out`` and
    hold both against the references at :func:`z_all` of all the settings;
    returns one record a setting."""
    k, z = z_all(SETTINGS)
    recs = {}
    for s in settings:
        rec = {}
        for label, div in (("band", 1), ("control", CONTROL_DIV)):
            folder = Path(out) / s / f"port_{device}_{label}"
            shutil.rmtree(folder, ignore_errors=True)
            t0 = time.perf_counter()
            train_port(s, folder, device=device, lr_div=div)
            holds, rows = hold(s, folder, z, root)
            rec[label] = {"holds": holds, "wall_s": time.perf_counter() - t0,
                          "widest": widest(rows), "means": means(rows)}
        rec["reference"] = means(rows, "ref")
        recs[s] = rec
        print(json.dumps({"setting": s, "k": k, "z": z, **rec}))
    return {"k": k, "z": z, "settings": recs}


def _cell(stats) -> str:
    return "; ".join(f"{m:.3f} [{lo:.2f}, {hi:.2f}]" for m, lo, hi in stats)


def table(cpu_dirs=(), card_log=None, root=ROOT) -> str:
    """``PERF.md``'s band table: a row a setting with accuracy's mean [min,
    max] at every epoch for ``qbmx`` (its reference), the port on the CPU
    (the folders ``port --device cpu`` wrote under ``cpu_dirs``) and on the
    card (phase 12's record, the ``{"kernels": ...}`` line of a
    ``chip_smoke.py`` log), the widest difference of the card's band (of
    its half-width) and the lr/10 controls' verdicts, all at z_k."""
    k, z = z_all(SETTINGS)
    card = {}
    if card_log:
        for line in Path(card_log).read_text().splitlines():
            if line.startswith('{"kernels"'):
                card = json.loads(line)["bands"]["settings"]
    lines = [f"k = {k} comparisons, z_k = {z:.4f}; accuracy mean [min, max] at epochs 1, 2, ...",
             "", "| Setting | `qbmx`, CPU | port, CPU | port, card | widest, card | "
                 "lr/10 control, CPU / card |", "|---|---|---|---|---|---|"]
    for s in SETTINGS:
        ref = seed_bands.load_bands(reference_dir(s, root))
        refm = [(ref["acc"][:, e].mean(), ref["acc"][:, e].min(), ref["acc"][:, e].max())
                for e in range(ref["acc"].shape[1])]
        cpu, ctl = "not run", []
        for d in cpu_dirs:
            folder = Path(d) / s / "port_cpu_band"
            if folder.is_dir():
                holds, rows = hold(s, folder, z, root)
                cpu = f"{_cell(means(rows)['acc'])} ({'holds' if holds else 'FAILS'})"
                ctl.append("fails" if not hold(s, Path(d) / s / "port_cpu_control", z, root)[0]
                           else "HOLDS")
        c = card.get(s)
        if c:
            w = c["band"]["widest"]
            card_cell = f"{_cell(c['band']['means']['acc'])} ({'holds' if c['band']['holds'] else 'FAILS'})"
            widest_cell = f"{w['metric']} e{w['epoch']} {w['diff']:+.3f} of ±{w['half_width']:.3f}"
            ctl_card = "fails" if not c["control"]["holds"] else "HOLDS"
        else:
            card_cell, widest_cell, ctl_card = "not run", "—", "not run"
        lines.append(f"| `{s}` | {_cell(refm)} | {cpu} | {card_cell} | {widest_cell} | "
                     f"{'/'.join(ctl) or 'not run'} / {ctl_card} |")
    return "\n".join(lines)


def main(argv_=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("reference", help="run qbmx's CLI on the CPU and commit its band")
    r.add_argument("settings", nargs="+", choices=list(SETTINGS))
    r.add_argument("--root", default=str(ROOT), help="the folder of the references")
    p = sub.add_parser("port", help="the port's band and control against the references")
    p.add_argument("settings", nargs="+", choices=list(SETTINGS))
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True, help="the folder for the port's sweeps")
    p.add_argument("--root", default=str(ROOT), help="the folder of the references")
    t = sub.add_parser("table", help="PERF.md's band table")
    t.add_argument("--cpu", nargs="*", default=[], help="folders of `port --device cpu` runs")
    t.add_argument("--card", default=None, help="a chip_smoke.py log with phase 12's record")
    args = ap.parse_args(argv_)
    if args.cmd == "table":
        print(table(args.cpu, args.card))
        return 0
    if args.cmd == "reference":
        for s in args.settings:
            m = write_reference(s, args.root)
            print(json.dumps({"setting": s, "wall_seconds": m["wall_seconds"],
                              **m["final_epoch"]}))
        return 0
    recs = run_port(args.settings, args.out, device=args.device, root=args.root)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"port_{args.device}.json").write_text(json.dumps(recs, indent=1))
    bad = [s for s, r in recs["settings"].items() if not r["band"]["holds"]
           or r["control"]["holds"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""Where two versions of tempest_tpu_torch part on the canonical problem,
and how good each one's fits are there.

Runs A (the paired 10-D Rosenbrock of `chip_smoke.py` and `bench.py`,
n_particles=1024, n_total=8192, clustered, float32, `on_device=False`) with
one seed in this checkout's package and in another version's (`--parent
DIR`, a directory holding that version's `tempest_tpu_torch/`), each in a
process of its own. Every iteration's stages are recorded by wrapping the
functions `iteration.py` calls: the cluster fit (`hgm_fit`), the labels
(`cluster_predict`), the mode fits (`fit_mode_statistics`) and the commit,
as digests of their inputs and outputs, with beta, the MCMC steps, the
leaf count and the modes whose Student-t dof sits at the floor of its
multisection (exp(-69) = 1e-30). The first iteration where the two runs
differ, and the first stage there whose outputs differ on equal inputs,
locate the parting. On that stage's inputs (saved by this checkout's run,
equal bit for bit to the other's) the script then fits again, in a process
per version and dtype: each version in float32 and in float64, the
float64 fit of this checkout being the reference. It prints, for each
float32 fit, its distance from the reference beside the other version's.

    python3 scripts/fit_witness.py --parent build/parent [--seed 42] [--device cuda] [--at T ...]

The fits of this checkout's run at the iterations `--at` are compared as
well (iteration 21 where the runs do not part, as on the CPU, where both
sum in the same order). The rows of both runs
and the comparison go to `--out` (default chiprun_out/fit_witness.json),
and the mode fits' inputs of each compared iteration beside it
(`<out>_inputs_<t>.npz`), where `scripts/fit_witness_jax.py` fits them
with the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
NU_FLOOR = 1e-20  # a dof below this sits at the multisection's floor, 1e-30
N_DIM, N_PARTICLES, N_TOTAL, CAPACITY = 10, 1024, 8192, 64


def _digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _import_package(root: str):
    sys.path.insert(0, os.path.abspath(root))
    import tempest_tpu_torch
    where = Path(tempest_tpu_torch.__file__).resolve().parents[1]
    if where != Path(root).resolve():
        raise RuntimeError(f"imported tempest_tpu_torch from {where}, not {root}")
    return tempest_tpu_torch


def trace(root: str, seed: int, device: str, out: str, inputs_dir: str) -> None:
    """Run A in the package at `root`, recording each iteration's stages;
    save each mutation iteration's fit inputs under `inputs_dir`."""
    import torch
    _import_package(root)
    from tempest_tpu_torch import Sampler
    from tempest_tpu_torch import iteration as it

    rows, row = [], {}
    inner = {name: getattr(it, name) for name in
             ("hgm_fit", "cluster_predict", "fit_mode_statistics", "commit")}

    def hgm_fit(u, w, keep, **kwargs):
        model, labels, n = inner["hgm_fit"](u, w, keep, **kwargs)
        row["hgm_in"] = _digest(u, w, keep)
        row["hgm_out"] = _digest(model.centers, model.covariances, model.weights, labels)
        row["n_leaves"] = int(n)
        row["_hgm"] = dict(u=u.cpu(), w=w.cpu(), keep=keep.cpu(), kwargs={
            k: (v.cpu() if torch.is_tensor(v) else v) for k, v in kwargs.items() if k != "loops"})
        return model, labels, n

    def cluster_predict(model, u):
        labels = inner["cluster_predict"](model, u)
        row["labels"] = _digest(model.centers, u, labels)
        return labels

    def fit_mode_statistics(u, w, labels, **kwargs):
        modes = inner["fit_mode_statistics"](u, w, labels, **kwargs)
        row["modes_in"] = _digest(u, w, labels)
        row["modes_out"] = _digest(modes.means, modes.covariances, modes.degrees_of_freedom)
        real = modes.k_mask.cpu()
        dof = modes.degrees_of_freedom.cpu()
        row["modes"] = int(real.sum())
        row["nu_floor"] = int(((dof < NU_FLOOR) & real).sum())
        row["_modes"] = dict(u=u.cpu(), w=w.cpu(), labels=labels.cpu(), kwargs={
            k: v for k, v in kwargs.items() if k != "loops"})
        return modes

    def commit(hist, cur):
        hist = inner["commit"](hist, cur)
        t = int(hist.t)
        row.update(t=t, beta=float(cur.beta), steps=int(cur.steps),
                   committed=_digest(hist.u[:, t - 1], hist.logl[t - 1]))
        saved = {k: row.pop(k) for k in ("_hgm", "_modes") if k in row}
        if saved:
            torch.save(saved, Path(inputs_dir) / f"{t}.pt")
        rows.append(dict(row))
        row.clear()
        return hist

    for name, fn in (("hgm_fit", hgm_fit), ("cluster_predict", cluster_predict),
                     ("fit_mode_statistics", fit_mode_statistics), ("commit", commit)):
        setattr(it, name, fn)

    def prior(u):
        return 20.0 * u - 10.0

    def rosenbrock(x):
        x1, x2 = x[..., ::2], x[..., 1::2]
        return -torch.sum(100.0 * (x2 - x1**2) ** 2 + (1.0 - x1) ** 2, dim=-1)

    s = Sampler(prior, rosenbrock, n_dim=N_DIM, n_particles=N_PARTICLES, vectorize=True,
                clustering=True, history_capacity=CAPACITY, random_state=seed, device=device)
    t0 = time.perf_counter()
    s.run(n_total=N_TOTAL, progress=False, on_device=False)
    wall = time.perf_counter() - t0
    Path(out).write_text(json.dumps(dict(root=root, seed=seed, device=device, wall=wall,
                                         logz=s.evidence()[0], rows=rows)))


def fit(root: str, inputs_dir: str, ts: str, dtype: str, device: str, out: str) -> None:
    """Fit the saved inputs of iterations `ts` (comma-separated) again in
    the package at `root`, in `dtype`."""
    import torch
    _import_package(root)
    from tempest_tpu_torch.cluster import hgm_fit
    from tempest_tpu_torch.modes import fit_mode_statistics

    dt = getattr(torch, dtype)

    def on(t):
        return t.to(device=device, dtype=dt if t.is_floating_point() else t.dtype)

    fits = {}
    for t in map(int, ts.split(",")):
        saved = torch.load(Path(inputs_dir) / f"{t}.pt")
        res = fits[t] = {}
        if "_hgm" in saved:
            h = saved["_hgm"]
            kwargs = {k: (on(v) if torch.is_tensor(v) else v) for k, v in h["kwargs"].items()}
            model, labels, n = hgm_fit(on(h["u"]), on(h["w"]), on(h["keep"]), **kwargs)
            res["hgm"] = dict(centers=model.centers.double().cpu(), labels=labels.cpu(),
                              k_mask=model.k_mask.cpu(), n_leaves=int(n))
        m = saved["_modes"]
        modes = fit_mode_statistics(on(m["u"]), on(m["w"]), on(m["labels"]), **m["kwargs"])
        res["modes"] = dict(means=modes.means.double().cpu(),
                            covs=modes.covariances.double().cpu(),
                            dof=modes.degrees_of_freedom.double().cpu(),
                            k_mask=modes.k_mask.cpu())
    torch.save(fits, out)


def _child(*args) -> None:
    env = {**os.environ, "PYTHONPATH": ""}
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), *map(str, args)],
                          env=env, cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{' '.join(map(str, args))} failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")


STAGES = ("hgm_out", "labels", "modes_out", "steps", "committed")


def first_parting(rows_a, rows_b):
    """(t, stage) of the first recorded value that differs; None if none."""
    for ra, rb in zip(rows_a, rows_b):
        for key in ("beta",) + STAGES:
            if ra.get(key) != rb.get(key):
                return ra["t"], key
    return None


def distances(got: dict, ref: dict) -> dict:
    """A float32 fit's distance from the float64 reference, per real mode."""
    import torch
    m, r = got["modes"], ref["modes"]
    real = r["k_mask"] & m["k_mask"]
    scale = torch.clamp(torch.amax(torch.abs(r["covs"]), dim=(1, 2)), min=1e-300)
    nu, nu_ref = m["dof"][real], r["dof"][real]
    out = dict(
        modes=int(real.sum()),
        mean_abs=float(torch.amax(torch.abs(m["means"] - r["means"])[real])),
        cov_rel=float(torch.amax(torch.amax(torch.abs(m["covs"] - r["covs"]), dim=(1, 2))[real]
                                 / scale[real])),
        log_nu_abs=float(torch.amax(torch.abs(torch.log(nu) - torch.log(nu_ref)))),
        nu_floor=int((nu < NU_FLOOR).sum()), nu_floor_ref=int((nu_ref < NU_FLOOR).sum()),
        nu=[float(v) for v in nu], nu_ref=[float(v) for v in nu_ref])
    if "hgm" in got and "hgm" in ref:
        g, h = got["hgm"], ref["hgm"]
        out["hgm"] = dict(n_leaves=g["n_leaves"], n_leaves_ref=h["n_leaves"],
                          labels_differ=int((g["labels"] != h["labels"]).sum()))
        if g["n_leaves"] == h["n_leaves"]:
            k = h["k_mask"]
            out["hgm"]["centers_abs"] = float(torch.amax(torch.abs(g["centers"] - h["centers"])[k]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory holding the other version's tempest_tpu_torch/")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--at", type=int, nargs="*", default=[],
                    help="iterations of this checkout's run whose fits are also compared "
                         "(default: 21 where the runs do not part)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "fit_witness.json"))
    ap.add_argument("--trace", nargs=3, metavar=("ROOT", "OUT", "INPUTS"), help=argparse.SUPPRESS)
    ap.add_argument("--fit", nargs=5, metavar=("ROOT", "INPUTS", "TS", "DTYPE", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.trace:
        return trace(args.trace[0], args.seed, args.device, args.trace[1], args.trace[2])
    if args.fit:
        return fit(*args.fit[:4], args.device, args.fit[4])
    if not args.parent:
        ap.error("--parent is required")
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {smi.stdout.strip()}", flush=True)

    import torch
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build" if (REPO / "build").is_dir() else None
                                     ) as tmp:
        tmp = Path(tmp)
        runs = {}
        for name, root in (("parent", args.parent), ("this", str(REPO))):
            (tmp / name).mkdir()
            _child("--seed", args.seed, "--device", args.device, "--trace", root,
                   tmp / f"{name}.json", tmp / name)
            runs[name] = json.loads((tmp / f"{name}.json").read_text())
            r = runs[name]
            print(f"{name}: logZ {r['logz']!r}, {len(r['rows'])} iterations, "
                  f"{sum(x['steps'] for x in r['rows'] if x['beta'] > 0)} MCMC steps, "
                  f"wall {r['wall']:.3f} s", flush=True)
            print(f"{name} steps by iteration: {[x['steps'] for x in r['rows']]}", flush=True)
            print(f"{name} leaves by iteration: {[x.get('n_leaves') for x in r['rows']]}",
                  flush=True)
            print(f"{name} modes at the nu floor by iteration (of the real modes): "
                  f"{[(x.get('nu_floor'), x.get('modes')) for x in r['rows']]}", flush=True)

        parting = first_parting(runs["parent"]["rows"], runs["this"]["rows"])
        ladder = next((a["t"] for a, b in zip(runs["parent"]["rows"], runs["this"]["rows"])
                       if a["beta"] != b["beta"]), None)
        ts = ([parting[0]] if parting else []) + (args.at or ([] if parting else [21]))
        print(f"first parting: {parting or 'none'}; the ladders part at iteration {ladder}; "
              f"fits compared at iterations {ts}", flush=True)
        rows_at = {n: next(x for x in r["rows"] if x["t"] == ts[0]) for n, r in runs.items()}
        same_in = {k: rows_at["parent"].get(k) == rows_at["this"].get(k)
                   for k in ("hgm_in", "modes_in")}
        print(f"inputs at iteration {ts[0]} equal in both runs: {same_in}", flush=True)

        fits = {}
        for name, root in (("parent", args.parent), ("this", str(REPO))):
            for dtype in ("float32", "float64"):
                out = tmp / f"fit_{name}_{dtype}.pt"
                _child("--device", args.device, "--fit", root, tmp / "this",
                       ",".join(map(str, ts)), dtype, out)
                fits[f"{name} {dtype}"] = torch.load(out)
        report = {}
        for t in ts:
            ref = fits["this float64"][t]
            report[t] = {k: distances(v[t], ref) for k, v in fits.items()}
            for k, v in report[t].items():
                brief = {a: b for a, b in v.items() if a not in ("nu", "nu_ref")}
                print(f"iteration {t}, {k} against this float64: {json.dumps(brief)}; nu "
                      f"{[float(f'{x:.4g}') for x in v['nu']]}", flush=True)
        # The mode fits' inputs, for scripts/fit_witness_jax.py.
        import numpy as np
        for t in ts:
            m = torch.load(tmp / "this" / f"{t}.pt")["_modes"]
            np.savez(Path(args.out).with_name(f"{Path(args.out).stem}_inputs_{t}.npz"),
                     u=m["u"].numpy(), w=m["w"].numpy(), labels=m["labels"].numpy(),
                     **{k: np.asarray(v) for k, v in m["kwargs"].items()})
        summary = dict(parting=parting, ladder_parts=ladder, at=ts, inputs_equal=same_in,
                       distances=report, runs={n: {k: r[k] for k in ("logz", "wall", "rows")}
                                               for n, r in runs.items()})
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(f"written: {args.out}", flush=True)


if __name__ == "__main__":
    main()

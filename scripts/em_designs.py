"""The EM kernels of this tree and of another commit on one NVIDIA GPU: the
split of an EM iteration into its phases, and device times in turns.

    python3 scripts/em_designs.py [--parent DIR] [--calls 5] [--split-only]

DIR is a checkout of another commit, e.g. `git archive <commit> | tar -x
-C build/parent`. Each package runs in processes of its own (this script
with `--worker`, importing `tempest_tpu_torch` from that package's root
through chip_smoke.py's `--package-root`), on the same inputs: the fits of
chip_smoke.py's phase 4d (its EM_GMM_SHAPES, EM_GMM_EXTRA and
EM_MODE_SHAPES, made by its `em_gmm_inputs` and `em_mode_inputs`) and A's
own fit inputs at iteration 21 (`a_fit_inputs`, made once by this tree's
package and saved under build/em_designs/, so both packages fit the same
points).

1. The split: each package's sources are built once more with clock64
   stamps (`csrc/em_stamps.cuh`; a commit older than that header gets it,
   and the marks at the same places of its loops, by `stamp_parent`), and
   one launch of each case reports the SM cycles its first CTA spent in
   each phase of an EM iteration, averaged over its first fit's iterations,
   in microseconds at the SM clock (chip_smoke.em_split).
2. The times (unless --split-only): each case's device ms a launch from
   torch.profiler's records of the kernel (chip_smoke.device_ms), in turns:
   parent, this, this, parent (this, this without --parent).

The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = Path(REPO) / "build" / "em_designs"
# The float64 cases the split covers: A's and B's shapes.
SPLIT_F64 = ("A run", " A (", " B (", "(16, 2048, 10, 2, 'full')")

# Marks at the phase boundaries of the EM loops of a commit without
# csrc/em_stamps.cuh (the sources of f22493e, the one-cluster design):
# (file, text, replacement), each text found exactly once.
PARENT_MARKS = (
    ("em_common.cuh", '#include <stdint.h>\n', '#include <stdint.h>\n\n#include "em_stamps.cuh"\n'),
    ("gmm_em.cu", "  int parity = 0;\n  while (!h.done && h.n_iter < max_iter) {  // CTA- and "
     "cluster-uniform\n",
     "  em::Stamps st;\n  st.start();\n  int parity = 0;\n  while (!h.done && h.n_iter < max_iter) "
     "{  // CTA- and cluster-uniform\n    st.iteration();\n"),
    ("gmm_em.cu", "    // The E-step: log densities,", "    st.mark(0);\n    // The E-step: log "
     "densities,"),
    ("gmm_em.cu", "    {\n      const T v[1] = {lbacc};", "    st.mark(1);\n    {\n      const T "
     "v[1] = {lbacc};"),
    ("gmm_em.cu", "    cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, "
     "static_cast<int>(lay.e1),",
     "    st.mark(2);\n    cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, "
     "static_cast<int>(lay.e1),"),
    ("gmm_em.cu", "    parity ^= 1;\n\n    const T new_lb", "    parity ^= 1;\n    st.mark(3);\n\n"
     "    const T new_lb"),
    ("gmm_em.cu", "    weighted_sums(StageScatter<T>", "    st.mark(6);\n    weighted_sums("
     "StageScatter<T>"),
    ("gmm_em.cu", "    cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, "
     "static_cast<int>(lay.e2),",
     "    st.mark(4);\n    cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, "
     "static_cast<int>(lay.e2),"),
    ("gmm_em.cu", "    parity ^= 1;\n    const int per = d * (d + 1) / 2;",
     "    parity ^= 1;\n    st.mark(5);\n    const int per = d * (d + 1) / 2;"),
    ("gmm_em.cu", "  if (rank == 0) {\n    for (int i = t; i < K; i += nt) a.pi",
     "  st.mark(6);\n  st.finish();\n  if (rank == 0) {\n    for (int i = t; i < K; i += nt) a.pi"),
    ("mvstud_em.cu", "  int parity = 0;\n  while (h.active) {  // CTA- and cluster-uniform\n",
     "  em::Stamps st;\n  st.start();\n  int parity = 0;\n  while (h.active) {  // CTA- and "
     "cluster-uniform\n    st.iteration();\n"),
    ("mvstud_em.cu", "    // The squared distances of this CTA's points.",
     "    st.mark(0);\n    // The squared distances of this CTA's points."),
    ("mvstud_em.cu", "    // _opt_nu: the Gaussian-limit test", "    st.mark(1);\n    // _opt_nu: "
     "the Gaussian-limit test"),
    ("mvstud_em.cu", "      cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, 1, "
     "mine, tot);\n      parity ^= 1;\n",
     "      st.mark(2);\n      cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, "
     "1, mine, tot);\n      parity ^= 1;\n      st.mark(3);\n"),
    ("mvstud_em.cu", "      T acc[kSplit - 1];\n", "      st.mark(6);\n      T acc[kSplit - 1];\n"),
    ("mvstud_em.cu", "      cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, "
     "kSplit - 1, mine, tot);\n      parity ^= 1;\n",
     "      st.mark(2);\n      cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C, "
     "kSplit - 1, mine, tot);\n      parity ^= 1;\n      st.mark(3);\n"),
    ("mvstud_em.cu", "      weighted_sums(StageM<T>", "      st.mark(6);\n      weighted_sums("
     "StageM<T>"),
    ("mvstud_em.cu", "      cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C,\n"
     "                  static_cast<int>(lay.e), mine, tot);\n      parity ^= 1;\n",
     "      st.mark(4);\n      cluster_sum(cluster, rows + parity * buf_elems, lay.emax, rank, C,\n"
     "                  static_cast<int>(lay.e), mine, tot);\n      parity ^= 1;\n"
     "      st.mark(5);\n"),
    ("mvstud_em.cu", "  if (rank == 0) {\n    for (int i = t; i < d; i += nt) a.mu",
     "  st.mark(6);\n  st.finish();\n  if (rank == 0) {\n    for (int i = t; i < d; i += nt) a.mu"),
)


def stamp_parent(src: Path) -> None:
    """Add csrc/em_stamps.cuh and PARENT_MARKS to a copy of an older csrc/."""
    shutil.copy(Path(REPO) / "tempest_tpu_torch" / "csrc" / "em_stamps.cuh", src)
    for name, old, new in PARENT_MARKS:
        text = (src / name).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the parent's loop is not the one PARENT_MARKS marks "
                             f"({old[:60]!r} found {text.count(old)} times)")
        (src / name).write_text(text.replace(old, new))


def stamped_sources(root: str, tag: str) -> Path:
    """A copy of root's csrc/ built with EM_STAMPS defined."""
    out = OUT / f"stamped_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(Path(root) / "tempest_tpu_torch" / "csrc", out)
    if not (out / "em_stamps.cuh").exists():
        stamp_parent(out)
    header = out / "em_common.cuh"
    header.write_text("#define EM_STAMPS 1\n" + header.read_text())
    return out


# ---------------------------------------------------------------------------
# The worker: one package's cases
# ---------------------------------------------------------------------------
def cases(cs, device, a_inputs):
    """(label, kind, run) of every case: run() launches the kernel once."""
    import torch

    tc, ts = cs.cluster_module, cs.student_module
    out = []
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        cast = (lambda t: t) if dtype == torch.float32 else (
            lambda t: t.double() if t.is_floating_point() else t)
        Xb, sw, carry, cov = max(a_inputs["gmm"], key=lambda g: g[0].shape[0])
        Xb, sw = cast(Xb.to(device)), cast(sw.to(device))
        carry = {e: cast(v.to(device)) for e, v in carry.items()}
        out.append((f"gmm_em A run {tuple(Xb.shape)} {tag}", "gmm_em",
                    lambda Xb=Xb, sw=sw, carry=carry, cov=cov: tc._gmm_em(
                        Xb, sw, carry, 1000, 1e-3, 1e-6, cov, None)))
        for i, (B, n, d, K, cov) in enumerate(list(cs.EM_GMM_SHAPES.values())
                                              + list(cs.EM_GMM_EXTRA)):
            Xb, sw, carry = cs.em_gmm_inputs(device, B, n, d, K, cov, dtype, seed=i)
            out.append((f"gmm_em {(B, n, d, K, cov)} {tag}", "gmm_em",
                        lambda Xb=Xb, sw=sw, carry=carry, cov=cov: tc._gmm_em(
                            Xb, sw, carry, 1000, 1e-3, 1e-6, cov, None)))
        mc, mk = a_inputs["mode"][0]
        mc = {e: cast(v.to(device)) for e, v in mc.items()}
        mk = {e: cast(v.to(device)) for e, v in mk.items()}
        out.append((f"mvstud_em A run {tuple(mk['wbar'].shape)} {tag}", "mvstud_em",
                    lambda mc=mc, mk=mk: ts._mode_em(mc, mk, None)))
        for label, (K, n, d) in cs.EM_MODE_SHAPES.items():
            mc, mk = cs.em_mode_inputs(device, K, n, d, dtype, seed=K + d)
            out.append((f"mvstud_em {label} {(K, n, d)} {tag}", "mvstud_em",
                        lambda mc=mc, mk=mk: ts._mode_em(mc, mk, None)))
    return out


def worker(mode: str, root: str, inputs: str, calls: int) -> None:
    import torch

    import chip_smoke as cs  # imports tempest_tpu_torch from --package-root
    from tempest_tpu_torch.ops import cuda_em

    device = torch.device("cuda")
    a_inputs = torch.load(inputs)
    result = {"package": os.path.dirname(os.path.dirname(os.path.abspath(cuda_em.__file__)))}
    if mode == "split":
        picked = [c for c in cases(cs, device, a_inputs)
                  if not c[0].endswith("f64") or any(k in c[0] for k in SPLIT_F64)]
        result["split"] = cs.em_split(picked, stamped_sources(root, "parent" if root != REPO
                                                              else "this"))
    else:
        result["device_ms"] = {label: cs.device_ms(run, f"{kind}_kernel", calls=calls)
                               for label, kind, run in cases(cs, device, a_inputs)}
    print("WORKER " + json.dumps(result), flush=True)


def save_a_inputs(cs) -> Path:
    """A's fit inputs at iteration 21 (this tree's package), saved for the workers."""
    import torch

    OUT.mkdir(parents=True, exist_ok=True)
    inputs = OUT / "a_inputs.pt"
    a = cs.a_fit_inputs(torch.device("cuda"))
    cpu = lambda c: {k: v.cpu() for k, v in c.items()}  # noqa: E731
    torch.save({"gmm": [(X.cpu(), sw.cpu(), cpu(c), cov) for X, sw, c, cov in a["gmm"]],
                "mode": [(cpu(c), cpu(k)) for c, k in a["mode"]]}, inputs)
    return inputs


def run_worker(mode: str, root: str, inputs: Path, calls: int) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", mode,
                           "--package-root", root, "--inputs", str(inputs),
                           "--calls", str(calls)],
                          capture_output=True, text=True, timeout=1800)
    line = [x for x in proc.stdout.splitlines() if x.startswith("WORKER ")]
    if proc.returncode != 0 or not line:
        raise SystemExit(f"worker {mode} {root} failed ({proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return json.loads(line[-1][len("WORKER "):])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", metavar="DIR", help="a checkout of another commit")
    parser.add_argument("--calls", type=int, default=5)
    parser.add_argument("--split-only", action="store_true")
    parser.add_argument("--worker", choices=("split", "times"), help=argparse.SUPPRESS)
    parser.add_argument("--package-root", help=argparse.SUPPRESS)
    parser.add_argument("--inputs", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        sys.path.insert(0, REPO)
        worker(args.worker, args.package_root, args.inputs, args.calls)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    inputs = save_a_inputs(cs)
    roots = {"this": REPO}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    split = {}
    for tag, root in roots.items():
        split[tag] = run_worker("split", root, inputs, 1)["split"]
        for label, r in split[tag].items():
            us = {k: round(v, 3) for k, v in r["us_an_iteration"].items()}
            print(f"split {tag} {label}: {r['iterations']} iterations of its first fit; us an "
                  f"iteration {json.dumps(us)}, {r['us_total']:.3f} in all; its CTAs' loops "
                  f"{json.dumps(r['ctas'])}", flush=True)
    times = {tag: [] for tag in roots}
    if not args.split_only:
        order = ("parent", "this", "this", "parent") if args.parent else ("this", "this")
        for tag in order:
            times[tag].append(run_worker("times", roots[tag], inputs, args.calls)["device_ms"])
            print(f"{tag}: {json.dumps({k: round(v, 4) for k, v in times[tag][-1].items()})}",
                  flush=True)
        if args.parent:
            for label in times["this"][0]:
                new = [t[label] for t in times["this"]]
                old = [t[label] for t in times["parent"]]
                print(f"in turns {label}: this {new[0]:.4f} / {new[1]:.4f} ms, parent "
                      f"{old[0]:.4f} / {old[1]:.4f} ms, ratio {min(old) / min(new):.2f}x",
                      flush=True)
    print(json.dumps({"em_designs": {"card": card, "split": split, "device_ms": times}}),
          flush=True)


if __name__ == "__main__":
    main()

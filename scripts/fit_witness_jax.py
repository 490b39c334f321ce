"""The JAX package's Student-t mode fits on the inputs `fit_witness.py` saved.

    python scripts/fit_witness_jax.py [--witness chiprun_out/fit_witness.json] [--x64]

For each iteration the witness compared, loads its mode fits' inputs
(`<witness>_inputs_<t>.npz`: the fit points, their weights and labels, as
this checkout's run on the card fed them) and runs
`tempest_tpu.modes.fit_mode_statistics` on them on the CPU, in float32 (or
float64 with `--x64`). It prints each real mode's dof and the modes at the
floor of the dof multisection (below 1e-20; the floor is 1e-30), beside
the float32 and float64 fits of the port that the witness recorded. The
last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

NU_FLOOR = 1e-20


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--witness", default="chiprun_out/fit_witness.json")
    ap.add_argument("--x64", action="store_true", help="fit in float64")
    args = ap.parse_args()
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    from tempest_tpu.modes import fit_mode_statistics

    dtype = jnp.float64 if args.x64 else jnp.float32
    witness = Path(args.witness)
    summary = json.loads(witness.read_text())
    out = {}
    for t in summary["at"]:
        z = np.load(witness.with_name(f"{witness.stem}_inputs_{t}.npz"))
        modes = fit_mode_statistics(jnp.asarray(z["u"], dtype), jnp.asarray(z["w"], dtype),
                                    jnp.asarray(z["labels"]), k_max=int(z["k_max"]),
                                    dof_fallback=float(z["dof_fallback"]))
        real = np.asarray(modes.k_mask)
        nu = np.asarray(modes.degrees_of_freedom, np.float64)[real]
        port = summary["distances"][str(t)]
        row = dict(nu=[float(f"{v:.4g}") for v in nu], nu_floor=int((nu < NU_FLOOR).sum()),
                   port_float32_floor=port["this float32"]["nu_floor"],
                   parent_float32_floor=port["parent float32"]["nu_floor"],
                   port_float64_floor=port["this float64"]["nu_floor"])
        out[t] = row
        print(f"iteration {t}: JAX {np.dtype(dtype).name} modes at the dof floor {row['nu_floor']} "
              f"of {len(nu)} (the port: float32 {row['port_float32_floor']}, the parent's "
              f"float32 {row['parent_float32_floor']}, float64 {row['port_float64_floor']}); "
              f"JAX dof {row['nu']}", flush=True)
    print(json.dumps({"dtype": np.dtype(dtype).name, "fits": out}), flush=True)


if __name__ == "__main__":
    main()

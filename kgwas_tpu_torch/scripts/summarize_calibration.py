"""The calibration protocol's summary table from its per-seed JSONs.

Counterpart of the JAX package's ``scripts/summarize_calibration.py``: the
same text from the same directory of JSONs (``run_calibration``'s, of
either package), so the summary can always be recomputed from them.

    python -m kgwas_tpu_torch.scripts.summarize_calibration [OUT_DIR]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def summary(out_dir: str) -> str:
    rows = []
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                rows.append(json.load(f))

    lines = []
    for arm in ("null", "causal"):
        sub = [r for r in rows if r["arm"] == arm]
        if not sub:
            continue
        gl = np.array([r["gwas_loci"] for r in sub])
        kl = np.array([r["kgwas_loci"] for r in sub])
        gh = np.array([r["gwas_hits"] for r in sub])
        kh = np.array([r["kgwas_hits"] for r in sub])
        w = np.array([r["wall_s"] for r in sub])
        lines.append(f"{arm}: n={len(sub)}")
        lines.append(f"  loci  GWAS mean={gl.mean():.3f} max={gl.max()}  "
                     f"KGWAS mean={kl.mean():.3f} max={kl.max()}  "
                     f"seeds with KGWAS loci>0: {(kl > 0).sum()}")
        lines.append(f"  hits  GWAS mean={gh.mean():.2f}  "
                     f"KGWAS mean={kh.mean():.2f}")
        lines.append(f"  wall  mean={w.mean():.1f}s "
                     f"total={w.sum()/60:.1f}min")
        if arm == "causal":
            tg = np.array([r["gwas_true_pos"] for r in sub])
            tk = np.array([r["kgwas_true_pos"] for r in sub])
            fg = np.array([r["gwas_false_pos"] for r in sub])
            fk = np.array([r["kgwas_false_pos"] for r in sub])
            lines.append(f"  power TP of {sub[0]['n_causal']} causal: GWAS "
                         f"mean={tg.mean():.1f}  KGWAS mean={tk.mean():.1f}")
            lines.append(f"  FP among hits: GWAS mean={fg.mean():.2f} "
                         f"KGWAS mean={fk.mean():.2f}")
    return "".join(line + "\n" for line in lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="calib_results",
                    help="run_calibration's --out-dir")
    args = ap.parse_args(argv)
    print(summary(args.out_dir), end="")


if __name__ == "__main__":
    main()

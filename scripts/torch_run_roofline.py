"""The single-pod roofline table of the PyTorch/H100 port: per (arch x
shape) the dry run's full-depth trace on the fake 16 x 16 mesh
(repro_torch.roofline.analysis), its three terms against the H100's
peaks, written as JSON rows to ``--out`` (nothing reads it).

    PYTHONPATH=src python scripts/torch_run_roofline.py --out table.json \
        [--arch A --shape S]

It runs on the CPU: the trace is shapes only.
"""
import argparse
import json
import time
import traceback

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, shape_supported
from repro_torch.roofline.analysis import analyze

ASSIGNED = [a for a in ARCHS if not a.startswith("gpt2")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--out", required=True, help="write the JSON rows here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    rows = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if not shape_supported(cfg, SHAPES[shape_name]):
                continue
            t0 = time.time()
            try:
                row = analyze(cfg, shape_name, multi_pod=False).row()
                row["derive_s"] = round(time.time() - t0, 1)
                rows.append(row)
            except Exception:
                traceback.print_exc()
                rows.append({"arch": arch, "shape": shape_name,
                             "error": True})
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {args.out} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()

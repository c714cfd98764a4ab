"""Hillclimb driver: hypothesis → config change → re-count → measure.

The port of ``repro.launch.hillclimb``: the same cells, tags and config
transforms, each counted by ``launch.dryrun.lower_cell`` on the meta
device (no card). The hypotheses say what each knob changes in the port.
Variants whose knob the sharded step refuses (the MoE families, and
``seq_shard_acts``/``moe_dispatch_sharding`` under ``dp=``, ROADMAP P11c)
get a row whose collectives and temp bytes are null with the reason;
their cost is still counted. Results append to ``--out``:

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell llama --upto v1
"""

from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.launch.dryrun import lower_cell

# variant registries: list of (tag, hypothesis, cfg_transform)
VARIANTS = {
    "granite": {
        "arch": "granite-moe-1b-a400m",
        "shape": "train_4k",
        "steps": [
            ("v0-baseline", "full TP-16 of a d_ff=512 MoE model", lambda c: c),
            (
                "v1-ep-only",
                "replicate dense and attention weights, keep EP over the experts and the vocab shards",
                lambda c: c.replace(tp_strategy="ep_only"),
            ),
            (
                "v2-ep-dispatch",
                "v1 + the (E,C,d) dispatch layout hint",
                lambda c: c.replace(tp_strategy="ep_only", moe_dispatch_sharding=True),
            ),
            (
                "v3-scatter-combine",
                "v2 + one gate-weighted scatter-add in place of the k combine gathers",
                lambda c: c.replace(tp_strategy="ep_only", moe_dispatch_sharding=True, moe_scatter_combine=True),
            ),
            (
                "v4-seq-shard",
                "v3 + sequence-parallel activations over 'model'",
                lambda c: c.replace(tp_strategy="ep_only", moe_dispatch_sharding=True, moe_scatter_combine=True,
                                    seq_shard_acts=True),
            ),
        ],
    },
    "deepseek": {
        "arch": "deepseek-v3-671b",
        "shape": "train_4k",
        "steps": [
            ("v0-baseline", "TP-16 everywhere, expert shards included", lambda c: c),
            (
                "v1-ep-only",
                "EP over the 256 experts with the dense and MLA weights replicated",
                lambda c: c.replace(tp_strategy="ep_only"),
            ),
            (
                "v2-ep-dispatch",
                "v1 + the (E,C,d) dispatch layout hint",
                lambda c: c.replace(tp_strategy="ep_only", moe_dispatch_sharding=True),
            ),
            (
                "v3-dispatch-only",
                "baseline TP for MLA and dense layers, with the dispatch layout hint",
                lambda c: c.replace(moe_dispatch_sharding=True),
            ),
            (
                "v4-scatter-combine",
                "v3 + one scatter-add in place of the top-8 combine gathers",
                lambda c: c.replace(moe_dispatch_sharding=True, moe_scatter_combine=True),
            ),
            (
                "v5-save-acts",
                "v4 + the remat policy that saves the sublayer outputs",
                lambda c: c.replace(moe_dispatch_sharding=True, moe_scatter_combine=True, remat="save_acts"),
            ),
            (
                "v6-seq-shard",
                "v5 + sequence-parallel activations",
                lambda c: c.replace(moe_dispatch_sharding=True, moe_scatter_combine=True, remat="save_acts",
                                    seq_shard_acts=True),
            ),
            (
                "v7-scatter-nopin",
                "scatter-combine and save_acts without the dispatch layout hint",
                lambda c: c.replace(moe_scatter_combine=True, remat="save_acts"),
            ),
        ],
    },
    "jamba": {
        "arch": "jamba-v0.1-52b",
        "shape": "train_4k",
        "steps": [
            ("v0-baseline", "MoE gather-combine baseline", lambda c: c),
            (
                "v1-scatter-combine",
                "one scatter-add combine on the third MoE arch",
                lambda c: c.replace(moe_scatter_combine=True),
            ),
        ],
    },
    "whisper": {
        "arch": "whisper-tiny",
        "shape": "train_4k",
        "steps": [
            ("v0-baseline", "TP-16 of a d=384 model", lambda c: c),
            (
                "v1-dp-only",
                "drop TP (ep_only with no experts is pure DP)",
                lambda c: c.replace(tp_strategy="ep_only"),
            ),
        ],
    },
    "llama": {
        "arch": "llama3-405b",
        "shape": "train_4k",
        "steps": [
            ("v0-baseline", "TP-16 + DP-16, full remat", lambda c: c),
            (
                "v1-save-acts",
                "save the tagged attn_out/ffn_out: the backward recomputes less",
                lambda c: c.replace(remat="save_acts"),
            ),
            (
                "v2-save-seq",
                "v1 + sequence-parallel activations",
                lambda c: c.replace(remat="save_acts", seq_shard_acts=True),
            ),
            (
                "v3-fsdp",
                "v2 + FSDP: weights sharded over the data axis too",
                lambda c: c.replace(remat="save_acts", seq_shard_acts=True, fsdp=True),
            ),
            (
                "v4-fsdp-accum4",
                "v3 with 4 microbatches: fewer weight gathers, more activation memory",
                lambda c: c.replace(remat="save_acts", seq_shard_acts=True, fsdp=True, grad_accum=4),
            ),
            (
                "v5-fsdp-saveacts",
                "save_acts + FSDP without sequence parallelism",
                lambda c: c.replace(remat="save_acts", fsdp=True),
            ),
            (
                "v6-fsdp-full-remat",
                "full remat + FSDP: the lowest-memory point",
                lambda c: c.replace(fsdp=True),
            ),
            (
                "v7-fsdp-gather",
                "v5 + the per-layer weight gather knob (the port gathers each layer whole at block entry anyway)",
                lambda c: c.replace(remat="save_acts", fsdp=True, fsdp_gather_layers=True),
            ),
        ],
    },
}


def run_cell(cell: str, upto: str = None, out="build/hillclimb.json"):
    spec = VARIANTS[cell]
    results = []
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    for tag, hypothesis, tf in spec["steps"]:
        if any(r.get("variant") == tag and r.get("arch") == spec["arch"] for r in results):
            print(f"[hillclimb] skip {tag} (already recorded)")
            continue
        print(f"[hillclimb] {spec['arch']} {tag}: {hypothesis[:100]}")
        try:
            r = lower_cell(spec["arch"], spec["shape"], multi_pod=False, cfg_transform=tf, tag=tag)
            r["hypothesis"] = hypothesis
        except Exception as e:
            traceback.print_exc()
            r = {"arch": spec["arch"], "variant": tag, "error": repr(e), "hypothesis": hypothesis}
        results.append(r)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        if upto and tag.startswith(upto):
            break
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(VARIANTS) + ["all"], default="all")
    ap.add_argument("--upto", default=None)
    ap.add_argument("--out", default="build/hillclimb.json")
    args = ap.parse_args()
    cells = list(VARIANTS) if args.cell == "all" else [args.cell]
    for c in cells:
        run_cell(c, args.upto, args.out)


if __name__ == "__main__":
    main()

"""Train SuperPoint and MobileNetVLAD on the card, as the reference's tools do.

    python -m omniswarm_torch.train_entry superpoint --stage magicpoint \\
        --steps 2000 --out build/train/superpoint.npz
    python -m omniswarm_torch.train_entry superpoint --stage photometric \\
        --steps 2000 --descriptor-steps 4000 \\
        --resume omniswarm_tpu/models/weights/superpoint_synthetic.npz \\
        --save-every 200 --continue-out --fit-pca 256 --out build/train/sp.npz
    python -m omniswarm_torch.train_entry netvlad --arch 2 --revisit 0.35 \\
        --cosine --hard-eval --steps 24000 --out build/train/netvlad.npz

``superpoint_main`` takes the flags of ``tools/train_superpoint_tool.py``
and ``netvlad_main`` those of ``tools/train_netvlad_tool.py``, plus
``--device`` (the card unless ``cpu`` is asked for). Both write checkpoints
in the reference's npz layout, which the reference's loaders and the port's
``pretrained_extractor`` / ``pretrained_global_extractor`` read, and return
a summary dict. ``textured_eval`` gives the rows of
``tools/eval_superpoint_textured.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import torch

from omniswarm_torch.convert import (netvlad_params_from_flax,
                                     superpoint_params_from_flax)
from omniswarm_torch.models import netvlad as nv
from omniswarm_torch.models import superpoint as sp
from omniswarm_torch.models import train_netvlad as tnv
from omniswarm_torch.models import train_superpoint as tsp


def read_superpoint(path) -> Dict[str, torch.Tensor]:
    """A SuperPoint checkpoint in the reference's layout as the port's
    params: ``SuperPoint`` state dict plus the PCA when the file has one."""
    state = superpoint_params_from_flax(sp.load_flax_npz(path))
    pca = {k: state.pop(k) for k in ("pca_components", "pca_mean")
           if k in state}
    return {**sp.net_state(state), **pca}


def read_netvlad(path) -> Dict[str, torch.Tensor]:
    """A MobileNetVLAD checkpoint as the port's ``MobileNetVLAD`` state
    dict."""
    return nv.model_state(netvlad_params_from_flax(nv.load_netvlad_npz(path)))


def superpoint_main(argv=None) -> dict:
    """The SuperPoint curriculum: ``magicpoint`` (line-art corners) or
    ``photometric`` (textured surfaces with homographic-adaptation labels,
    then joint detector + descriptor training on eval-matched warps),
    optionally a fitted 256 -> 64 PCA. Resumable mid-stage with
    ``--save-every N --continue-out`` (OUT.resume.npz + OUT.state.json)."""
    ap = argparse.ArgumentParser(prog="train_entry superpoint")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--desc-batch", type=int, default=16)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--desc-lr", type=float, default=5e-4)
    ap.add_argument("--descriptor-steps", type=int, default=0,
                    help="joint detector+descriptor steps (stage 2)")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--stage", default="magicpoint",
                    choices=["magicpoint", "photometric"])
    ap.add_argument("--ha-every", type=int, default=4,
                    help="photometric stage: every Nth batch self-labels "
                         "by homographic adaptation (0 disables)")
    ap.add_argument("--max-rot", type=float, default=0.55)
    ap.add_argument("--max-shift", type=float, default=12.0)
    ap.add_argument("--scale-lo", type=float, default=0.8)
    ap.add_argument("--scale-hi", type=float, default=1.25)
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint OUT.resume.npz every N steps")
    ap.add_argument("--continue-out", action="store_true",
                    help="resume mid-stage from OUT.resume.npz/state.json")
    ap.add_argument("--fit-pca", type=int, default=0,
                    help="fit the 256->64 descriptor PCA on N rendered "
                         "images and embed it in the checkpoint")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    photo = args.stage == "photometric"
    batch_fn = tsp.make_batch_textured if photo else None
    render_fn = tsp.render_mixed if photo else None
    state_path = args.out + ".state.json"
    resume_path = args.out + ".resume.npz"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    state = {"stage": "detector", "step": 0}
    params = None
    if args.continue_out and os.path.exists(state_path) \
            and os.path.exists(resume_path):
        with open(state_path) as f:
            state = json.load(f)
        params = sp.net_state(read_superpoint(resume_path))
        print(f"step resume: stage={state['stage']} step={state['step']}",
              flush=True)
    elif args.resume:
        params = sp.net_state(read_superpoint(args.resume))

    def save_fn_for(stage):
        def save(p, it):
            sp.save_flax_npz(p, resume_path)
            with open(state_path, "w") as f:
                json.dump({"stage": stage, "step": it}, f)
        return save

    def log_det(h):
        print(f"step {h[0]:5d} loss {h[1]:.4f}", flush=True)

    def log_desc(h):
        it, loss, ld, lc = h
        print(f"step {it:5d} loss {loss:.4f} (desc {ld:.4f} det {lc:.4f})",
              flush=True)

    out = {"history_detector": [], "history_descriptor": []}
    if args.steps > 0 and state["stage"] == "detector":
        params, out["history_detector"] = tsp.train_detector(
            steps=args.steps, batch=args.batch, h=args.height, w=args.width,
            lr=args.lr, log_every=max(args.steps // 40, 1), params=params,
            batch_fn=batch_fn, ha_every=args.ha_every if photo else 0,
            start_step=state["step"], save_every=args.save_every,
            save_fn=save_fn_for("detector"), log_fn=log_det,
            device=args.device)
        state = {"stage": "descriptor", "step": 0}
        save_fn_for("descriptor")(params, 0)

    if args.descriptor_steps > 0 and state["stage"] in (
            "detector", "descriptor"):
        start = state["step"] if state["stage"] == "descriptor" else 0
        params, out["history_descriptor"] = tsp.train_descriptors(
            steps=args.descriptor_steps, batch=args.desc_batch,
            h=args.height, w=args.width, lr=args.desc_lr, params=params,
            log_every=max(args.descriptor_steps // 40, 1),
            batch_fn=batch_fn, render_fn=render_fn,
            max_rot=args.max_rot, max_shift=args.max_shift,
            scale=(args.scale_lo, args.scale_hi),
            start_step=start, save_every=args.save_every,
            save_fn=save_fn_for("descriptor"), log_fn=log_desc,
            device=args.device)

    full = dict(params)
    if args.fit_pca > 0:
        desc = tsp.sample_raw_descriptors(
            full, n_images=args.fit_pca, h=args.height, w=args.width,
            render_fn=tsp.render_textured if photo else None,
            device=args.device)
        comps, mean, ratio = tsp.fit_pca(desc, 64)
        print(f"step pca: {desc.shape[0]} descs, explained "
              f"{ratio.sum():.3f}", flush=True)
        full["pca_components"] = torch.from_numpy(comps)
        full["pca_mean"] = torch.from_numpy(mean)
        out["pca_explained"] = float(ratio.sum())

    if args.descriptor_steps > 0:
        mm = tsp.matching_metrics(
            full, n_eval=16, h=args.height, w=args.width, max_rot=0.5,
            max_shift=12.0, scale=(0.85, 1.2),
            render_fn=tsp.render_textured if photo else None,
            device=args.device)
        print(f"eval: match precision {mm['match_precision']:.3f} "
              f"over {mm['matches']} matches", flush=True)
        out["matching"] = mm
    m = tsp.detection_metrics(full, n_eval=32, device=args.device)
    print(f"eval: precision {m['precision']:.3f} recall {m['recall']:.3f}",
          flush=True)
    sp.save_flax_npz(full, args.out)
    with open(state_path, "w") as f:
        json.dump({"stage": "done", "step": 0}, f)
    print(f"saved {args.out}", flush=True)
    out.update(params=full, detection=m, out=args.out)
    return out


def netvlad_main(argv=None) -> dict:
    """Train MobileNetVLAD on synthetic places and save a checkpoint;
    evaluates easy 64-way recall@1 (and, with ``--hard-eval``, the 256-way
    revisit tier). ``--continue-out`` resumes from OUT.resume.npz (f32
    parameters and Adam's state) or from OUT itself."""
    ap = argparse.ArgumentParser(prog="train_entry netvlad")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--places", type=int, default=16)
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default=None,
                    help="checkpoint to continue from")
    ap.add_argument("--out", required=True)
    ap.add_argument("--temperature", type=float, default=0.1)
    ap.add_argument("--max-rot", type=float, default=0.25)
    ap.add_argument("--noise", type=float, default=0.03)
    ap.add_argument("--scale", type=float, nargs=2, default=(1.0, 1.0))
    ap.add_argument("--cosine", action="store_true")
    ap.add_argument("--revisit", type=float, default=None,
                    help="train view pairs as revisits within this fraction "
                         "of the view size (e.g. 0.35)")
    ap.add_argument("--hard-eval", action="store_true",
                    help="evaluate on the hard 256-way jittered revisit "
                         "benchmark")
    ap.add_argument("--save-every", type=int, default=1000,
                    help="checkpoint to --out every N steps (0 disables)")
    ap.add_argument("--continue-out", action="store_true",
                    help="if --out exists, resume from it")
    ap.add_argument("--textured", action="store_true",
                    help="textured place canvases (render_textured)")
    ap.add_argument("--arch", type=int, default=1, choices=(1, 2),
                    help="encoder version for fresh training (2 = "
                         "GroupNorm'd deeper encoder); resumed checkpoints "
                         "use their stored version")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    resume = args.resume
    resume_path = None
    if args.continue_out:
        resume_path = args.out + ".resume.npz"
        if os.path.exists(args.out):
            resume = args.out
            print(f"resuming from {args.out}", flush=True)
    arch = nv.netvlad_meta(resume)["encoder_version"] if resume else args.arch
    params = read_netvlad(resume) if resume else None
    params, history = tnv.train_netvlad(
        steps=args.steps, places_per_batch=args.places, pool_size=args.pool,
        lr=args.lr, seed=args.seed, params=params,
        log_every=max(args.steps // 20, 1), temperature=args.temperature,
        max_rot=args.max_rot, noise=args.noise, scale=tuple(args.scale),
        cosine=args.cosine, verbose=True, revisit_offset=args.revisit,
        save_every=args.save_every or None, save_path=args.out,
        resume_path=resume_path, encoder_version=arch,
        textured=args.textured, device=args.device)
    m = tnv.retrieval_metrics(params, encoder_version=arch,
                              textured=args.textured, device=args.device)
    print(f"eval(easy 64-way): recall@1 {m['recall_at_1']:.3f} "
          f"margin {m['mean_margin']:.3f}", flush=True)
    out = {"params": params, "history": history, "easy": m, "arch": arch,
           "out": args.out}
    if args.hard_eval:
        mh = tnv.retrieval_metrics(params, n_places=256, max_rot=0.5,
                                   noise=0.06, scale=(0.8, 1.25),
                                   revisit_offset=0.35, encoder_version=arch,
                                   textured=args.textured,
                                   device=args.device)
        print(f"eval(hard 256-way revisit): recall@1 "
              f"{mh['recall_at_1']:.3f} margin {mh['mean_margin']:.3f}",
              flush=True)
        out["hard"] = mh
    nv.save_netvlad_npz(params, args.out, encoder_version=arch)
    print(f"saved {args.out} (encoder v{arch})", flush=True)
    return out


# The three matching rows held for a checkpoint: the textured and flat rows
# of tools/eval_superpoint_textured.py (0.5 rad, zoom 0.85-1.2) and the
# default warp (0.3 rad, no zoom) on line art.
MATCHING_ROWS = {
    "textured": dict(max_rot=0.5, max_shift=12.0, scale=(0.85, 1.2),
                     render_fn=tsp.render_textured),
    "flat": dict(max_rot=0.5, max_shift=12.0, scale=(0.85, 1.2)),
    "easy": {},
}


def textured_eval(ckpts: Dict[str, str], *, n_eval: int = 24,
                  device="cuda") -> dict:
    """{name: {textured_/flat_match_precision, textured_/flat_matches}} for
    each checkpoint path: the rows of ``tools/eval_superpoint_textured.py``
    (a checkpoint without PCA goes through ``jl_projection()``)."""
    results = {}
    for name, path in ckpts.items():
        params = read_superpoint(path)
        res = {}
        for row in ("textured", "flat"):
            m = tsp.matching_metrics(params, n_eval=n_eval, device=device,
                                     **MATCHING_ROWS[row])
            res[f"{row}_match_precision"] = m["match_precision"]
            res[f"{row}_matches"] = m["matches"]
        print(f"[sp-eval] {name}: {json.dumps(res)}", flush=True)
        results[name] = res
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("superpoint", "netvlad"):
        print("usage: python -m omniswarm_torch.train_entry "
              "superpoint|netvlad [flags]", file=sys.stderr)
        return 2
    (superpoint_main if argv[0] == "superpoint" else netvlad_main)(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())

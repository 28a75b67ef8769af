"""Export CLI: SDF checkpoint -> textured mesh (port of
nerf_emitter_tpu/scripts/exporter.py, the `mi-marching-cubes` subcommand).

    python -m nerf_emitter_tpu_torch.scripts.exporter mi-marching-cubes \
        --load-config outputs/lego/sdf-nerfacto/config.json \
        --resolution 512 --output-dir exports/lego [--device cuda]

Loads the optimised SDF grid from a checkpointed run (or a raw .npy volume
with `--sdf-volume`), extracts the iso-surface at `--resolution`^3 (the
interpolant evaluated on the device), textures it from the albedo volume
and writes mesh.obj, mesh.ply and the volumes as .npy (sdf, albedo,
roughness). The run is restored through the trainer's template path
(`Trainer.load_checkpoint(step, bind=False)`): the scene arrays alone, with
no TSDF fusion, guiding build or distillation.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..utils.device import resolve_device


def cmd_marching_cubes(args) -> dict:
    from ..exporter.marching_cubes import sample_vertex_attributes, upsampled_marching_cubes, write_obj, write_ply

    dev = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.sdf_volume is not None:
        sdf = np.load(args.sdf_volume)
        albedo = np.load(args.albedo_volume) if args.albedo_volume else None
        roughness = None
    else:
        from ..configs.cli import load_config
        from ..engine.trainer import Trainer

        config = load_config(args.load_config)
        config.device = str(dev)
        trainer = Trainer(config)
        trainer.setup()
        try:
            trainer.load_checkpoint(args.checkpoint_step, bind=False)
        except FileNotFoundError:
            print("warning: no checkpoint; exporting init scene")
        if trainer.pipeline.sdf_state is None:
            # a pretrain-only checkpoint (or none): the init template's
            # scene, so the CLI still writes a mesh to look at
            trainer.pipeline.begin_takeover_template()
        scene = trainer.pipeline.sdf_state.scene
        sdf, albedo, roughness = (t.detach().cpu().numpy() for t in (scene.sdf, scene.albedo, scene.roughness))

    res = args.resolution
    verts, faces = upsampled_marching_cubes(sdf, res, device=dev)
    print(f"extracted {len(verts)} verts / {len(faces)} faces at res {res}")

    colors = None
    if albedo is not None:
        colors = sample_vertex_attributes(verts, albedo, roughness, device=dev)["albedo"]

    write_obj(out_dir / "mesh.obj", verts, faces, colors)
    write_ply(out_dir / "mesh.ply", verts, faces, colors)
    np.save(out_dir / "sdf.npy", sdf)
    if albedo is not None:
        np.save(out_dir / "albedo.npy", albedo)
    if roughness is not None:
        np.save(out_dir / "roughness.npy", roughness)
    print(f"wrote mesh + volumes to {out_dir}")
    return {"verts": len(verts), "faces": len(faces), "resolution": res}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="exporter")
    subs = ap.add_subparsers(dest="cmd", required=True)
    mc = subs.add_parser("mi-marching-cubes")
    mc.add_argument("--load-config", type=Path, default=None)
    mc.add_argument("--sdf-volume", type=Path, default=None, help="raw .npy SDF volume instead of a checkpoint")
    mc.add_argument("--albedo-volume", type=Path, default=None)
    mc.add_argument("--resolution", type=int, default=512)
    mc.add_argument("--checkpoint-step", type=int, default=None)
    mc.add_argument("--output-dir", type=Path, default=Path("exports"))
    mc.add_argument("--device", default="cuda")
    mc.set_defaults(fn=cmd_marching_cubes)
    args = ap.parse_args(argv)
    if args.sdf_volume is None and args.load_config is None:
        ap.error("give --load-config or --sdf-volume")
    return args.fn(args)


if __name__ == "__main__":
    main()

"""CLI: ``python -m kazen_tpu_torch.cli scene.xml [-o out.png|out.exr]`` --
the analog of the reference's ``kazen scene.xml`` (main.cpp:20-83), and
the port of ``kazen_tpu/cli/main.py``. ``--device`` (cuda unless asked
otherwise) takes the place of the reference's ``--platform``.

``--distributed`` renders with the lanes split over a torch.distributed
process group (dist/sharding.py:render_distributed): the group already
initialized, one from torchrun's environment, or else one of this process
alone; rank 0 writes the image.

``--trace FILE`` switches the program's tracer on (``utils/metrics.py``)
and writes its spans and counters as a Chrome trace (rank 0).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kazen-tpu")
    ap.add_argument("scene", help="scene XML file")
    ap.add_argument("-o", "--output", default=None, help="output PNG/EXR path")
    ap.add_argument("--spp", type=int, default=None, help="override sample count")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument(
        "--checkpoint", default=None, help="checkpoint file for resumable renders"
    )
    ap.add_argument(
        "--distributed",
        action="store_true",
        help="shard pixel lanes over the processes of a torch.distributed group",
    )
    ap.add_argument(
        "--trace", default=None, metavar="FILE",
        help="write the program's spans and counters as a Chrome trace (JSON)",
    )
    args = ap.parse_args(argv)

    from ..core.device import resolve_device
    from ..film import io as img_io
    from ..scene.compiler import compile_scene
    from ..scene.xml_io import load_xml
    from ..utils import metrics

    device = resolve_device(args.device)
    if args.trace:
        metrics.tracing(True)
    t0 = time.time()
    scene = load_xml(args.scene)
    arrays, static = compile_scene(scene, device=device)
    print(
        f"[kazen-tpu] compiled scene: {int(arrays.F.shape[0])} faces, "
        f"{static.num_lights} lights, {static.num_materials} materials, "
        f"{static.width}x{static.height} @ {static.sample_count} spp "
        f"({time.time() - t0:.2f}s)",
        file=sys.stderr,
    )

    t0 = time.time()
    rank = 0
    if args.distributed:
        import torch.distributed as dist

        from ..dist.multihost import ensure_group
        from ..dist.sharding import render_distributed

        own_group = ensure_group(device)
        try:
            img = render_distributed(arrays, static, spp=args.spp)
            rank = dist.get_rank()
        finally:
            if own_group:
                dist.destroy_process_group()
    elif args.checkpoint:
        from ..film.checkpoint import render_resumable

        img = render_resumable(arrays, static, spp=args.spp, checkpoint_path=args.checkpoint)
    else:
        from ..integrate.render import render

        img = render(arrays, static, spp=args.spp, device=device)
    img = img.cpu()
    dt = time.time() - t0
    if args.trace:
        metrics.tracing(False)
        collected = metrics.collect()
        if rank == 0:
            metrics.write_chrome_trace(args.trace, collected)
    spp = args.spp or static.sample_count
    mps = static.width * static.height * spp / dt
    print(
        f"[kazen-tpu] rendered in {dt:.2f}s "
        f"({mps / 1e6:.2f} Mpixel-samples/s)",
        file=sys.stderr,
    )
    if rank != 0:
        return

    out = args.output or (args.scene.rsplit(".", 1)[0] + ".png")
    if out.endswith(".exr"):
        img_io.save_exr(out, img)
    else:
        img_io.save_png(out, img)
    print(f"[kazen-tpu] wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()

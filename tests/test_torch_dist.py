"""The port's distributed layer on torch.distributed with CPU processes
(gloo): images and inverse-step gradients of 2 and 3 processes (3 gives
uneven lane slices) against one process, at tests/test_dist.py's
tolerances. Each process group runs once per world size, with its own
time limit."""
import pickle

import numpy as np
import pytest
import torch

from kazen_tpu_torch.core import rng
from kazen_tpu_torch.dist import multihost, sharding
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.scene import compiler as comp_t

from torch_port_helpers import multi_cluster_scene, run_ranks, to_port

_WORKER = r"""
import os, pickle, sys
port, rank, world, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
import numpy as np, torch
torch.set_num_threads(2)
import torch.distributed as dist
from kazen_tpu_torch.core import rng
from kazen_tpu_torch.dist import multihost, sharding
from kazen_tpu_torch.integrate.render import pixel_grid, sampler_spec
from kazen_tpu_torch.scene.compiler import compile_scene

multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
assert dist.get_backend() == "gloo" and dist.get_world_size() == world
assert dist.get_rank() == rank
with open(os.path.join(outdir, "case.pkl"), "rb") as f:
    desc, grad_desc, target = pickle.load(f)
arrays, static = compile_scene(desc, device="cpu")  # every rank builds the scene
out = {"slice": np.asarray(multihost.local_lane_slice(static.width * static.height))}
out["render"] = sharding.render_distributed(arrays, static, spp=2).numpy()
for b in (1, 2):
    out[f"samples_{b}"] = sharding.render_sample_sharded(
        arrays, static, spp=4, sample_batches=b).numpy()
ga, gs = compile_scene(grad_desc, device="cpu")
step = sharding.inverse_train_step(ga, gs, sampler_spec(gs, "cpu"))
px, py = pixel_grid(gs, "cpu")
loss, grads = step(ga, torch.from_numpy(target), px, py, 0, rng.advance_constants(0))
out["loss"] = float(loss)
for k, v in grads.items():
    out["grad_" + k] = v.numpy()
np.savez(os.path.join(outdir, f"out_{rank}.npz"), **out)
dist.destroy_process_group()
print("WORKER_OK", rank)
"""


def _cases():
    desc = to_port(multi_cluster_scene(width=16, height=16, spp=4))
    grad_desc = to_port(multi_cluster_scene(width=12, height=12))
    grad_desc.integrator.max_depth = 2
    target = (0.3 * np.random.default_rng(2).random((12, 12, 3))).astype(np.float32)
    return desc, grad_desc, target


@pytest.fixture(scope="module", params=[2, 3], ids=["2proc", "3proc"])
def group_run(request, tmp_path_factory):
    """One process group of 2 or 3 ranks running every case; their outputs
    by rank, and the cases."""
    world = request.param
    outdir = tmp_path_factory.mktemp(f"world{world}")
    cases = _cases()
    with open(outdir / "case.pkl", "wb") as f:
        pickle.dump(cases, f)
    outs = run_ranks(_WORKER, world, args=(outdir,), timeout=300.0)
    for rank, out in enumerate(outs):
        assert f"WORKER_OK {rank}" in out, out[-2000:]
    return world, [dict(np.load(outdir / f"out_{r}.npz")) for r in range(world)], cases


@pytest.fixture(scope="module")
def single():
    """The same cases in this process, as a world of one."""
    desc, grad_desc, target = _cases()
    arrays, static = comp_t.compile_scene(desc, device="cpu")
    ga, gs = comp_t.compile_scene(grad_desc, device="cpu")
    step = sharding.inverse_train_step(ga, gs, render_t.sampler_spec(gs, "cpu"))
    px, py = render_t.pixel_grid(gs, "cpu")
    loss, grads = step(ga, torch.from_numpy(target), px, py, 0, rng.advance_constants(0))
    return {
        "render_2": render_t.render(arrays, static, spp=2, device="cpu").numpy(),
        "render_4": render_t.render(arrays, static, spp=4, device="cpu").numpy(),
        "loss": float(loss),
        "grads": {k: v.numpy() for k, v in grads.items()},
    }


def test_lane_slices_cover_the_frame(group_run):
    """multihost.initialize joined every rank; local_lane_slice splits the
    256 lanes into contiguous slices (86, 86, 84 for three ranks)."""
    world, outs, _ = group_run
    bounds = [tuple(o["slice"]) for o in outs]
    assert bounds[0][0] == 0 and bounds[-1][1] == 256
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert len({b[1] - b[0] for b in bounds}) == (2 if world == 3 else 1)


def test_render_distributed_matches_single(group_run, single):
    _, outs, _ = group_run
    for o in outs:
        np.testing.assert_allclose(o["render"], single["render_2"], atol=1e-5)
        np.testing.assert_array_equal(o["render"], outs[0]["render"])


@pytest.mark.parametrize("batches", [1, 2])
def test_sample_sharded_matches_single(group_run, single, batches):
    _, outs, _ = group_run
    for o in outs:
        np.testing.assert_allclose(o[f"samples_{batches}"], single["render_4"], atol=1e-5)


def test_inverse_train_step_matches_single(group_run, single):
    """The loss of the reduced film and the summed gradients equal one
    process's (tests/test_dist.py's tolerances); a gradient taken through a
    differentiable all-reduce would be scaled by the world size."""
    _, outs, _ = group_run
    assert np.abs(single["grads"]["base_color"]).max() > 0.0
    for o in outs:
        np.testing.assert_allclose(o["loss"], single["loss"], rtol=1e-5)
        for k, g in single["grads"].items():
            np.testing.assert_allclose(o["grad_" + k], g, rtol=2e-4, atol=1e-6, err_msg=k)


def test_world_of_one_without_a_group():
    """initialize is a no-op for one process; without a process group every
    function runs as a world of one, and the jump table's rows are
    render()'s jumps."""
    import torch.distributed as dist

    multihost.initialize("127.0.0.1:1", 1, 0, device="cpu")
    assert not dist.is_initialized()
    assert multihost.rank_and_size() == (0, 1)
    assert multihost.local_lane_slice(10) == (0, 10)
    table = sharding.jump_table([0, 3], "cpu")
    for row, s in zip(table.tolist(), (0, 3)):
        assert row == [rng.s64(v) for v in rng.advance_constants(s * 65536)]
    assert multihost.backend_for("cpu") == "gloo" and multihost.backend_for("cuda") == "nccl"


_CLI_WORKER = r"""
import os, sys
port, rank, world, xml, out = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank, LOCAL_RANK=rank,
                  WORLD_SIZE=world)
import torch
torch.set_num_threads(2)
from kazen_tpu_torch.cli.main import main
main([xml, "-o", out, "--spp", "2", "--distributed", "--device", "cpu"])
print("WORKER_OK", rank)
"""


def test_cli_distributed_over_two_processes(tmp_path):
    """The CLI launched as two processes with torchrun's environment: the
    ranks split the lanes over a gloo group, rank 0 alone writes the image,
    and it equals one process's render."""
    from kazen_tpu_torch.film.io import load_exr
    from kazen_tpu_torch.scene.xml_io import load_xml

    from torch_port_helpers import write_xml_scene

    xml = write_xml_scene(tmp_path)
    out = str(tmp_path / "out.exr")
    outs = run_ranks(_CLI_WORKER, 2, args=(xml, out), timeout=240.0)
    assert "[kazen-tpu] wrote" in outs[0] and "[kazen-tpu] wrote" not in outs[1]
    arrays, static = comp_t.compile_scene(load_xml(xml), device="cpu")
    want = render_t.render(arrays, static, spp=2, device="cpu").numpy()
    np.testing.assert_allclose(load_exr(out), want, atol=1e-5)

"""The port's file front end against kazen_tpu's: EXR and PNG files, the
XML/OBJ scene importer, image-texture files, checkpoints, the band splat,
the CLI and the megakernel fall-back log line."""
import dataclasses
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.film import checkpoint as ck_j
from kazen_tpu.film import io as io_j
from kazen_tpu.integrate import render as render_j
from kazen_tpu.scene import obj as obj_j
from kazen_tpu.scene import xml_io as xml_j
from kazen_tpu_torch.film import checkpoint as ck_t
from kazen_tpu_torch.film import film as film_t
from kazen_tpu_torch.film import io as io_t
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.scene import compiler as comp_t
from kazen_tpu_torch.scene import description as DT
from kazen_tpu_torch.scene import obj as obj_t
from kazen_tpu_torch.scene import xml_io as xml_t

import scenes
from torch_port_helpers import (
    compile_port,
    compile_reference,
    multi_cluster_scene,
    reference_to_numpy,
    to_port,
    write_xml_scene,
)

# ---------------------------------------------------------------------------
# EXR
# ---------------------------------------------------------------------------


def test_exr_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((7, 13, 3)).astype(np.float32)
    p = str(tmp_path / "t.exr")
    io_t.save_exr(p, torch.from_numpy(img))
    np.testing.assert_array_equal(io_t.load_exr(p), img)


def test_exr_zip_roundtrip(tmp_path):
    img = (np.random.default_rng(1).random((37, 19, 3)) * 5).astype(np.float32)
    p = str(tmp_path / "t_zip.exr")
    io_t.save_exr(p, img, compression="zip")
    assert os.path.getsize(p) < 37 * 19 * 3 * 4 + 400  # actually compressed
    np.testing.assert_array_equal(io_t.load_exr(p), img)


@pytest.mark.parametrize("compression", ["none", "zip"])
def test_exr_crosses_packages(tmp_path, compression):
    """A file written by either package reads back exactly in the other,
    byte for byte the same file."""
    img = (np.random.default_rng(2).random((21, 17, 3)) * 3).astype(np.float32)
    pt, pj = str(tmp_path / "port.exr"), str(tmp_path / "ref.exr")
    io_t.save_exr(pt, img, compression=compression)
    io_j.save_exr(pj, img, compression=compression)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(io_j.load_exr(pt), img)
    np.testing.assert_array_equal(io_t.load_exr(pj), img)


def _exr_with_compression(path, comp_id, tiled=False):
    """A header-only EXR with the given compression id (4 = PIZ)."""
    def attr(name, type_name, data):
        return name.encode() + b"\0" + type_name.encode() + b"\0" + struct.pack("<i", len(data)) + data

    chlist = b"R\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1) + b"\0"
    header = (attr("channels", "chlist", chlist) + attr("compression", "compression", bytes([comp_id]))
              + attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, 3, 3)) + b"\0")
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", 20000630, 2 | (0x200 if tiled else 0)) + header + bytes(64))


@pytest.mark.parametrize("kind", ["piz", "tiled"])
def test_exr_unsupported_raises_reference_error(tmp_path, kind):
    p = str(tmp_path / f"{kind}.exr")
    _exr_with_compression(p, 4, tiled=kind == "tiled")
    with pytest.raises(ValueError, match="no cv2 fallback") as e_t:
        io_t.load_exr(p)
    assert ("tiled" in str(e_t.value)) == (kind == "tiled")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(path, img, ctype, depth, filters=(0, 1, 2, 3, 4), palette=None):
    """A PNG of ``img`` whose rows cycle through ``filters`` (all five
    filter types by default)."""
    h, w = img.shape[:2]
    ch = 1 if ctype == 3 else _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = np.ascontiguousarray(img.reshape(h, w * ch).astype(">u2" if depth == 16 else np.uint8))
    prev = bytes(w * bpp)
    out = bytearray()
    for y in range(h):
        x = rows[y].tobytes()
        f = filters[y % len(filters)]
        enc = bytearray(len(x))
        for i in range(len(x)):
            a = x[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            enc[i] = (x[i] - pred) & 0xFF
        out += bytes([f]) + enc
        prev = x

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)))
        if palette is not None:
            fh.write(chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
        fh.write(chunk(b"IDAT", zlib.compress(bytes(out))))
        fh.write(chunk(b"IEND", b""))


def _png_pixels(ctype, depth, h=11, w=9, seed=0):
    rng = np.random.default_rng(seed)
    shape = (h, w) if ctype == 0 else (h, w, _CHANNELS[ctype])
    return rng.integers(0, 1 << depth, shape, dtype=np.uint16 if depth == 16 else np.uint8)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype", [0, 2, 4, 6], ids=["gray", "rgb", "gray_alpha", "rgba"])
def test_png_decoder_exact(tmp_path, ctype, depth):
    """Every filter type, in each colour type at 8 and 16 bits: the decoded
    samples equal the encoded ones."""
    img = _png_pixels(ctype, depth)
    p = str(tmp_path / "t.png")
    _encode_png(p, img, ctype, depth)
    got = io_t.load_png(p)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


def test_png_palette_and_refusals(tmp_path):
    pal = np.random.default_rng(3).integers(0, 256, (16, 3))
    idx = np.random.default_rng(4).integers(0, 16, (6, 7)).astype(np.uint8)
    p = str(tmp_path / "pal.png")
    _encode_png(p, idx, 3, 8, palette=pal)
    np.testing.assert_array_equal(io_t.load_png(p), pal[idx])
    _encode_png(p, idx % 2, 0, 8)
    with open(p, "rb") as f:
        data = bytearray(f.read())
    data[24] = 1  # bit depth 1
    with open(p, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(NotImplementedError, match="bit depth 1"):
        io_t.load_png(p)


@pytest.mark.parametrize("mode", ["L", "RGB", "LA", "RGBA", "I;16"])
def test_png_decoder_against_pil(tmp_path, mode):
    """Files written by PIL (its own filter choices) decode to PIL's values."""
    Image = pytest.importorskip("PIL.Image")
    depth = 16 if mode == "I;16" else 8
    ctype = {"L": 0, "RGB": 2, "LA": 4, "RGBA": 6, "I;16": 0}[mode]
    img = _png_pixels(ctype, depth, h=23, w=31, seed=5)
    p = str(tmp_path / "pil.png")
    pil = Image.fromarray(img)
    assert pil.mode == mode
    pil.save(p)
    want = np.asarray(Image.open(p))
    np.testing.assert_array_equal(io_t.load_png(p).astype(np.int64), want.astype(np.int64))


def test_save_png_reads_back(tmp_path):
    img = np.random.default_rng(6).random((5, 8, 3)).astype(np.float32)
    p = str(tmp_path / "o.png")
    io_t.save_png(p, torch.from_numpy(img))
    np.testing.assert_array_equal(io_t.load_png(p), film_t.to_srgb8(torch.from_numpy(img)))


def test_texture_files_scaled_as_the_reference(tmp_path):
    """The reference's rule for what imageio reads: divide by 255 when the
    largest value exceeds 1.5 after the cast to float32, at any bit depth
    (a 16-bit file is divided by 255 too) and for EXR; other formats raise
    NotImplementedError naming the format."""
    img8 = _png_pixels(2, 8, seed=7)
    img16 = _png_pixels(2, 16, seed=8)
    p8, p16 = str(tmp_path / "a8.png"), str(tmp_path / "a16.png")
    _encode_png(p8, img8, 2, 8)
    _encode_png(p16, img16, 2, 16)
    np.testing.assert_array_equal(comp_t.read_texture_file(p8), img8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(comp_t.read_texture_file(p16), img16.astype(np.float32) / 255.0)
    dim = np.random.default_rng(9).random((4, 6, 3)).astype(np.float32)
    pe = str(tmp_path / "dim.exr")
    io_t.save_exr(pe, dim)
    np.testing.assert_array_equal(comp_t.read_texture_file(pe), dim)
    io_t.save_exr(pe, dim * 4.0)
    np.testing.assert_array_equal(comp_t.read_texture_file(pe), dim * 4.0 / 255.0)
    pj = str(tmp_path / "x.jpg")
    with open(pj, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(32))
    with pytest.raises(NotImplementedError, match="JPEG"):
        comp_t.read_texture_file(pj)


# ---------------------------------------------------------------------------
# OBJ and XML
# ---------------------------------------------------------------------------

_OBJ = """# a quad and a triangle, with uvs, normals and a missing uv
v -1 0 -1
v 1 0 -1
v 1 0.25 1
v -1 0 1
v 0.3 0.7 0.1234567891
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
vn 0.1 0.9 0
vn 0 1 0.2
vn 0 1 0
f 1/1/1 2/2/2 3/3/3 4/4/4
f 1//1 3/3/3 5//2
"""


@pytest.mark.parametrize("to_world", [False, True])
def test_obj_matches_reference(tmp_path, to_world):
    p = tmp_path / "m.obj"
    p.write_text(_OBJ)
    m = None
    if to_world:
        m = np.asarray(DT.lookat([0.3, 1.0, -2.0], [0, 0.5, 0], [0, 1, 0]), np.float32)
        m[:3, :3] *= np.asarray([1.5, 0.5, 2.0], np.float32)
    got = obj_t.load_obj(str(p), m)
    want = obj_j.load_obj(str(p), m)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _assert_same(a, b, path="scene"):
    """Two description trees equal field by field (arrays exactly)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    else:
        assert a == b, path


def test_xml_import(tmp_path):
    """The port's load_xml gives the reference's description (carried into
    the port's classes) field by field; both compile to equal arrays and
    render images that agree."""
    xml = write_xml_scene(tmp_path)
    got = xml_t.load_xml(xml)
    want = xml_j.load_xml(xml)
    assert isinstance(got, DT.Scene)
    _assert_same(got, to_port(want))
    assert got.camera.width == 12 and got.sampler.kind == "stratified"
    assert got.rfilter.kind == "gaussian"
    a_j, s_j = compile_reference(want)
    a_t, s_t = compile_port(want)
    arrays_j, static_j = reference_to_numpy(a_j, s_j)
    for name in ("V", "F", "N", "UV", "face_shade", "light_radiance", "light_cdf",
                 "cam_to_world", "sample_to_camera"):
        np.testing.assert_array_equal(getattr(a_t, name).numpy(), arrays_j[name], err_msg=name)
    for name, v in arrays_j["materials"].items():
        np.testing.assert_array_equal(getattr(a_t.materials, name).numpy(), v, err_msg=name)
    assert s_t.num_lights == static_j["num_lights"] == 1
    img_t = render_t.render(a_t, s_t, device="cpu").numpy()
    img_j = np.asarray(render_j.render(a_j, s_j))
    assert np.isfinite(img_t).all() and img_t.mean() > 0.001
    np.testing.assert_allclose(img_t.mean((0, 1)), img_j.mean((0, 1)), rtol=5e-3)
    share = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share


def test_xml_image_files_equal_in_memory_arrays(tmp_path):
    """An image texture (PNG, sRGB) and a background (EXR) read from files
    compile to the same tables as the same description with the decoded
    arrays given as data, and render the same image."""
    base = _png_pixels(2, 8, h=16, w=16, seed=10)
    _encode_png(str(tmp_path / "base.png"), base, 2, 8)
    sky = (0.2 + np.random.default_rng(11).random((8, 16, 3))).astype(np.float32)
    io_t.save_exr(str(tmp_path / "sky.exr"), sky)
    xml = write_xml_scene(tmp_path, extra="""
  <mesh type="obj">
    <string name="filename" value="quad.obj"/>
    <transform name="toWorld"><rotate axis="1 0 0" angle="-90"/>
      <translate value="0 1 1"/></transform>
    <bsdf type="lambertian">
      <texture type="imagetexture" id="albedo">
        <string name="filename" value="base.png"/>
      </texture>
    </bsdf>
  </mesh>
  <texture type="background" id="background">
    <texture type="imagetexture">
      <string name="filename" value="sky.exr"/><string name="colorspace" value="linear"/>
    </texture>
    <float name="intensity" value="0.5"/>
  </texture>""")
    desc = xml_t.load_xml(xml)
    assert desc.meshes[2].bsdf.albedo.filename == str(tmp_path / "base.png")
    mem = dataclasses.replace(desc)
    mem.meshes = list(desc.meshes)
    mem.meshes[2] = dataclasses.replace(desc.meshes[2], bsdf=DT.Lambertian(
        albedo=DT.ImageTexture(data=base.astype(np.float32) / 255.0)))
    mem.background = DT.Background(
        texture=DT.ImageTexture(data=sky, colorspace="linear"), intensity=0.5)
    a_f, s_f = comp_t.compile_scene(desc, device="cpu")
    a_m, s_m = comp_t.compile_scene(mem, device="cpu")
    assert s_f == s_m and s_f.has_image_textures
    for f in dataclasses.fields(a_f.textures):
        assert torch.equal(getattr(a_f.textures, f.name), getattr(a_m.textures, f.name)), f.name
    assert torch.equal(render_t.render(a_f, s_f, spp=1, device="cpu"),
                       render_t.render(a_m, s_m, spp=1, device="cpu"))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_resume_identical(tmp_path):
    """Resume equals a straight render bit for bit (counter-based streams)."""
    a_t, s_t = compile_port(scenes.cornell_box(width=12, height=12, spp=4))
    direct = render_t.render(a_t, s_t, spp=4, device="cpu")
    ck = str(tmp_path / "ck.npz")
    ck_t.render_resumable(a_t, s_t, spp=2, checkpoint_path=ck, checkpoint_every=2)
    film, nxt, seed = ck_t.load(ck)
    assert (film.shape, film.dtype, nxt, seed) == ((12, 12, 4), np.float32, 2, s_t.seed)
    resumed = ck_t.render_resumable(a_t, s_t, spp=4, checkpoint_path=ck, checkpoint_every=2)
    assert torch.equal(direct, resumed)
    assert ck_t.load(ck)[1] == 4


def _port_passes(a_t, s_t, film, samples):
    spec = render_t.sampler_spec(s_t, "cpu")
    px, py = render_t.pixel_grid(s_t, "cpu")
    film = torch.as_tensor(film).clone()
    for s in samples:
        from kazen_tpu_torch.core import rng

        film, _ = render_t._render_pass(a_t, s_t, spec, film, px, py, s, rng.advance_constants(s * 65536))
    return film_t.to_bitmap(film).numpy()


def _reference_passes(a_j, s_j, film, samples):
    from kazen_tpu.core import rng

    spec = render_j.sampler_spec(s_j)
    ys, xs = np.meshgrid(np.arange(s_j.height), np.arange(s_j.width), indexing="ij")
    px = jnp.asarray(xs.reshape(-1).astype(np.uint32))
    py = jnp.asarray(ys.reshape(-1).astype(np.uint32))
    film = jnp.asarray(film)
    for s in samples:
        a, c = rng.advance_constants(s * 65536)
        jump = ((jnp.uint32(a >> 32), jnp.uint32(a & 0xFFFFFFFF)),
                (jnp.uint32(c >> 32), jnp.uint32(c & 0xFFFFFFFF)))
        film, _ = render_j._render_pass(a_j, s_j, spec, film, px, py, jnp.uint32(s), jump)
    w = np.asarray(film)[..., 3:4]
    return np.where(w > 0, np.asarray(film)[..., :3] / np.maximum(w, 1e-9), 0.0)


def test_checkpoint_crosses_packages(tmp_path):
    """A checkpoint written by kazen_tpu resumes in the port at its next
    sample, and the reverse: each resume equals that package's passes from
    the other's film, within test_checkpoint_resume_identical's atol."""
    desc = scenes.cornell_box(width=12, height=12, spp=4)
    a_j, s_j = compile_reference(desc)
    a_t, s_t = compile_port(desc)
    ck_ref, ck_port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ck_j.render_resumable(a_j, s_j, spp=2, checkpoint_path=ck_ref, checkpoint_every=2)
    film_ref = ck_t.load(ck_ref)[0]
    got = ck_t.render_resumable(a_t, s_t, spp=4, checkpoint_path=ck_ref).numpy()
    np.testing.assert_allclose(got, _port_passes(a_t, s_t, film_ref, [2, 3]), atol=1e-6)
    ck_t.render_resumable(a_t, s_t, spp=2, checkpoint_path=ck_port, checkpoint_every=2)
    film_port = ck_j.load(ck_port)[0]
    got = np.asarray(ck_j.render_resumable(a_j, s_j, spp=4, checkpoint_path=ck_port))
    np.testing.assert_allclose(got, _reference_passes(a_j, s_j, film_port, [2, 3]), atol=1e-6)
    # and the two packages' films agree as their renders do
    share = np.isclose(film_port, film_ref, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share


# ---------------------------------------------------------------------------
# film band splat, CLI, log line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gaussian", "box", "mitchell"])
def test_splat_grid_band_matches_full(kind):
    """Row bands accumulated into the film equal the whole-grid splat
    (tests/test_features.py:test_splat_grid_band_matches_full's limits)."""
    _, static = compile_port(scenes.cornell_box(width=16, height=12))
    static = dataclasses.replace(static, rfilter_kind=kind, rfilter_radius=2.0)
    h, w = static.height, static.width
    rng = np.random.default_rng(0)
    jitter = torch.from_numpy(rng.random((h * w, 2), dtype=np.float32))
    value = torch.from_numpy(rng.random((h * w, 3), dtype=np.float32))
    full = film_t.splat_grid(static, film_t.make_film(static, "cpu"), jitter, value)
    film = film_t.make_film(static, "cpu")
    for row0 in range(0, h, 4):
        s = slice(row0 * w, (row0 + 4) * w)
        band = film_t.splat_grid_band(static, jitter[s], value[s])
        assert band.shape == (4 + 2 * film_t.band_border(static), w, 4)
        film_t.accumulate_band(static, film, band, row0)
    np.testing.assert_allclose(film.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)


def test_cli(tmp_path, capsys):
    """The CLI on the CPU: PNG (with --trace), EXR, --checkpoint and
    --distributed (gloo, a group of one process); the EXR equals render() of
    the same file."""
    import json

    from kazen_tpu_torch.cli.main import main

    xml = write_xml_scene(tmp_path)
    out_png, out_exr = str(tmp_path / "out.png"), str(tmp_path / "out.exr")
    trace = str(tmp_path / "trace.json")
    main([xml, "-o", out_png, "--spp", "2", "--device", "cpu", "--trace", trace])
    assert io_t.load_png(out_png).shape == (12, 12, 3)
    with open(trace) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    assert names.count("compile_scene") == 1 and names.count("render.pass") == 2
    main([xml, "-o", out_exr, "--spp", "2", "--device", "cpu"])
    a_t, s_t = comp_t.compile_scene(xml_t.load_xml(xml), device="cpu")
    direct = render_t.render(a_t, s_t, spp=2, device="cpu").numpy()
    np.testing.assert_array_equal(io_t.load_exr(out_exr), direct)
    ck = str(tmp_path / "ck.npz")
    out_ck = str(tmp_path / "ck.exr")
    main([xml, "-o", out_ck, "--spp", "2", "--checkpoint", ck, "--device", "cpu"])
    assert ck_t.load(ck)[1] == 2
    np.testing.assert_array_equal(io_t.load_exr(out_ck), direct)
    out_d = str(tmp_path / "dist.exr")
    main([xml, "-o", out_d, "--spp", "2", "--distributed", "--device", "cpu"])
    np.testing.assert_allclose(io_t.load_exr(out_d), direct, atol=1e-5)
    import torch.distributed as dist

    assert not dist.is_initialized()
    err = capsys.readouterr().err
    assert "[kazen-tpu] compiled scene: 4 faces, 1 lights" in err
    assert err.count("[kazen-tpu] wrote ") == 4


def test_megakernel_fallback_is_logged(capsys):
    """A small path_mis scene that falls off the megakernel says so on
    stderr, with the reason; one in its class says nothing."""
    comp_t.compile_scene(to_port(scenes.cornell_box(width=8, height=8)), device="cpu")
    assert "megakernel fast path declined" not in capsys.readouterr().err
    desc = to_port(scenes.cornell_box(width=8, height=8, sampler="pmj02bn"))
    comp_t.compile_scene(desc, device="cpu")
    err = capsys.readouterr().err
    assert "megakernel fast path declined (" in err
    assert "pmj02bn" in err and "using the wavefront + cluster trace" in err
    assert err.startswith("[kazen-tpu ")
    big = to_port(multi_cluster_scene(width=8, height=8))
    comp_t.compile_scene(big, device="cpu")  # beyond the class's size: no line
    assert "declined" not in capsys.readouterr().err


def test_log_timed_and_profiler_trace(tmp_path, capsys):
    """LOG and timed write the reference's line formats to stderr; the
    tracer's export writes a Chrome trace of what ran with it on, and an
    empty one of what ran with it off."""
    import json

    from kazen_tpu_torch.utils import metrics
    from kazen_tpu_torch.utils.metrics import LOG, timed

    LOG("hello")
    with timed("a block"):
        pass
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("[kazen-tpu ") and err[0].endswith("] hello")
    assert err[1].startswith("[kazen-tpu] a block: ") and err[1].endswith(" ms")
    a_t, s_t = compile_port(scenes.cornell_box(width=4, height=4, spp=1))
    with metrics.tracing():
        render_t.render(a_t, s_t, device="cpu")
    metrics.write_chrome_trace(str(tmp_path / "trace.json"), metrics.collect())
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert {"render.call", "render.pass", "camera", "sampler.draw", "splat"} <= {
        e["name"] for e in events}
    assert all(e["ph"] == "X" and e["dur"] >= 0 and "id" in e["args"] for e in events)
    assert doc["otherData"]["rays"] > 0
    render_t.render(a_t, s_t, device="cpu")
    metrics.write_chrome_trace(str(tmp_path / "off.json"), metrics.collect())
    with open(tmp_path / "off.json") as f:
        assert json.load(f)["traceEvents"] == []

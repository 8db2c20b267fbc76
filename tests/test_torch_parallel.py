"""The port's row-tile sharded fractal P step and ``FractalCodec(mesh=)`` on
meshes of CPU slots: the halo exchange, the tiled step equal to the
unsharded plane step (trees, coefficients, reconstruction) at
``tests/test_parallel.py``'s shapes, the tiled step equal to the JAX
package's over its virtual CPU devices, the sharded stream equal to the
unsharded one and to the JAX codec's, and the dry run of every sharded path
on three CPU slots."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as JP

from h264tpu.models.fractal_codec import FractalCodec as JFractalCodec
from h264tpu.parallel.tiled_search import tiled_p_step as j_tiled_p_step
from h264tpu.utils.config import (CodecConfig as JConfig,
                                  FractalConfig as JFractalConfig)
from h264tpu_torch.models.fractal_codec import FractalCodec, FractalDecoder
from h264tpu_torch.ops import fractal as F
from h264tpu_torch.parallel import Mesh
from h264tpu_torch.parallel.dryrun import dryrun_multichip
from h264tpu_torch.parallel.tiled_search import (halo_exchange_rows,
                                                 tiled_p_step)
from h264tpu_torch.utils.config import CodecConfig, FractalConfig

H, W, SR, TILE_ROWS, QP = 128, 64, 3, 4, 28     # tests/test_parallel.py
MAP_KEYS = ("a", "beta", "dx", "dy", "ref", "shape")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(gop: int, tile: int) -> Mesh:
    return Mesh([["cpu"] * tile] * gop, ("gop", "tile"))


def batch_planes(seed: int, B: int):
    """(y, u, v, ref_y, ref_u, ref_v) int32 [B, ...] random pixels."""
    rng = np.random.default_rng(seed)
    shapes = ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2)) * 2
    return [rng.integers(0, 256, s).astype(np.int32) for s in shapes]


def test_mesh_shape_and_slots():
    mesh = Mesh(np.array([["cpu", "cpu", "cpu"]], dtype=object),
                ("gop", "tile"))
    assert mesh.shape == {"gop": 1, "tile": 3} and mesh.size == 3
    assert mesh.axis_devices("tile") == [torch.device("cpu")] * 3
    assert mesh.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        Mesh(["cpu", "cpu"], ("gop", "tile"))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_halo_exchange_rows(n):
    """Each halo'd tile is its rows of the edge-replicated frame."""
    halo = 4
    x = torch.as_tensor(np.random.default_rng(n).integers(0, 256, (64, 24)),
                        dtype=torch.int32)
    ext = halo_exchange_rows(list(torch.split(x, 64 // n)), halo)
    full = torch.cat([x[:1].expand(halo, -1), x, x[-1:].expand(halo, -1)])
    hl = 64 // n
    assert len(ext) == n
    for t, e in enumerate(ext):
        torch.testing.assert_close(e, full[t * hl:t * hl + hl + 2 * halo],
                                   rtol=0, atol=0)
    with pytest.raises(ValueError):
        halo_exchange_rows(list(torch.split(x, 2)), halo)


def unsharded_codec(deblock: bool) -> FractalCodec:
    cfg = CodecConfig(width=W, height=H, qp=QP, intra_period=0,
                      deblock=deblock, tile_rows=TILE_ROWS,
                      fractal=FractalConfig(search_range=SR))
    return FractalCodec(cfg, device="cpu")


@pytest.mark.parametrize("deblock", [True, False], ids=["deblock", "plain"])
@pytest.mark.parametrize("gop,tile", [(1, 1), (1, 2), (2, 2), (1, 4)])
def test_tiled_step_equals_unsharded(gop, tile, deblock):
    planes = [torch.as_tensor(a) for a in batch_planes(gop * 10 + tile, gop)]
    step = tiled_p_step(cpu_mesh(gop, tile), search_range=SR, tol16=10.5,
                        tol8=8.0, use_halfpel=True, deblock=deblock,
                        tile_rows=TILE_ROWS)
    maps_t, zz_t, rec_t = step(*planes, QP)
    codec = unsharded_codec(deblock)
    for b in range(gop):
        maps_s, zz_s, rec_s = codec._p_step(*(p[b] for p in planes), QP)
        for pi in range(3):
            assert torch.equal(rec_t[pi][b], rec_s[pi]), (b, pi)
            assert torch.equal(zz_t[pi][b], zz_s[pi]), (b, pi)
            for k in MAP_KEYS:
                assert torch.equal(maps_t[pi][k][b], maps_s[pi][k]), (b, pi, k)


def test_tiled_step_refuses_bad_layouts():
    with pytest.raises(ValueError, match="multiple"):
        tiled_p_step(cpu_mesh(1, 4), search_range=SR, tol16=10.5, tol8=8.0,
                     tile_rows=6)
    with pytest.raises(ValueError, match="axes"):
        tiled_p_step(Mesh(["cpu"], ("slice",)), search_range=SR, tol16=10.5,
                     tol8=8.0)
    step = tiled_p_step(cpu_mesh(1, 8), search_range=SR, tol16=10.5,
                        tol8=8.0, tile_rows=8)
    with pytest.raises(ValueError, match="16-row"):
        step(*[torch.as_tensor(a) for a in batch_planes(0, 1)], QP)


def test_tiled_step_equals_jax_tiled_step():
    """The JAX package's tiled step on a (1, 2) mesh of its virtual CPU
    devices (``tests/conftest.py``), deblock on."""
    planes = batch_planes(7, 1)
    jmesh = JMesh(np.array(jax.devices()[:2]).reshape(1, 2), ("gop", "tile"))
    kw = dict(search_range=SR, tol16=10.5, tol8=8.0, use_halfpel=True,
              deblock=True, tile_rows=TILE_ROWS)
    sh = NamedSharding(jmesh, JP("gop", "tile", None))
    j_out = jax.jit(j_tiled_p_step(jmesh, **kw))(
        *(jax.device_put(jnp.asarray(a), sh) for a in planes), jnp.int32(QP))
    t_out = tiled_p_step(cpu_mesh(1, 2), **kw)(
        *(torch.as_tensor(a) for a in planes), QP)
    (jm, jz, jr), (tm, tz, tr) = j_out, t_out
    for pi in range(3):
        np.testing.assert_array_equal(tr[pi].numpy(), np.asarray(jr[pi]))
        np.testing.assert_array_equal(tz[pi].numpy(), np.asarray(jz[pi]))
        for k in MAP_KEYS:
            np.testing.assert_array_equal(tm[pi][k].numpy(),
                                          np.asarray(jm[pi][k]))


def test_sharded_codec_stream_equals_unsharded_and_jax():
    """FractalCodec over a (1, 3) mesh at 96x128, tile_rows 3, 3 frames:
    the stream equals the unsharded one and the JAX codec's, and the
    decoder reproduces the reconstruction."""
    h, w = 96, 128
    rng = np.random.default_rng(5)
    frames = [tuple(rng.integers(0, 256, s).astype(np.uint8)
                    for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
              for _ in range(3)]
    fields = dict(width=w, height=h, qp=QP, intra_period=8, deblock=True,
                  tile_rows=3)
    cfg = CodecConfig(**fields, fractal=FractalConfig(search_range=SR))
    mesh = cpu_mesh(1, 3)
    F.cross_cell_sums.launches = 0
    res3, s3 = FractalCodec(cfg, mesh=mesh).encode_sequence(frames)
    assert F.cross_cell_sums.launches == 0     # the plain version on CPU
    res1, s1 = FractalCodec(cfg, device="cpu").encode_sequence(frames)
    _, sj = JFractalCodec(JConfig(
        **fields, fractal=JFractalConfig(search_range=SR))).encode_sequence(
            frames)
    assert s3 == s1 == sj
    for r, planes in zip(res3, FractalDecoder(device="cpu").decode(s3)):
        for a, b in zip(r.recon, planes):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="tile_rows"):
        FractalCodec(cfg, mesh=cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="gop"):
        FractalCodec(cfg, mesh=cpu_mesh(3, 1))


def test_dryrun_multichip_on_cpu_slots(capsys):
    out = dryrun_multichip(3, ["cpu"] * 3)
    text = capsys.readouterr().out
    for stage in range(1, 5):
        assert f"stage {stage} OK" in text
    assert min(out.values()) > 0

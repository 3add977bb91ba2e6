"""The port's coordinate conversions against the JAX package's, function
by function, in float64 on the CPU: 1e-12 relative (radians, km, unit
vectors), NaN positions equal. Inputs are seeded and include the poles,
the antimeridian and a zero vector where the JAX function defines a result.
"""

import numpy as np
import pytest
import torch

from auromat_tpu.coordinates import transform as jt
from auromat_tpu.coordinates.frames import FrameMatrices as JFrameMatrices
from auromat_tpu_torch.coordinates import transform as tt
from auromat_tpu_torch.coordinates.frames import FrameMatrices
from datetime import datetime

T0 = datetime(2012, 2, 7, 6, 41, 9)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _angles(seed=0, n=200):
    """(lat, lon) radians with the poles, the equator, the antimeridian."""
    rng = np.random.default_rng(seed)
    lat = np.concatenate([rng.uniform(-np.pi / 2, np.pi / 2, n),
                          [np.pi / 2, -np.pi / 2, 0.0, 0.3, 0.3]])
    lon = np.concatenate([rng.uniform(-np.pi, np.pi, n),
                          [0.1, 0.2, 0.0, np.pi, -np.pi]])
    return lat, lon


def _vecs(seed=1, n=200):
    """(n, 3) km vectors near the emission layer, with both poles, an
    antimeridian point and the zero vector."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * rng.uniform(
        6300.0, 7000.0, (n, 1))
    return np.concatenate([v, [[0.0, 0.0, 6466.0], [0.0, 0.0, -6466.0],
                               [-6488.0, 0.0, 10.0], [0.0, 0.0, 0.0]]])


def _close(got, want, scale=1.0):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


def _rot(seed=2):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q


def test_spherical_to_cartesian():
    lat, lon = _angles()
    r = np.random.default_rng(3).uniform(1.0, 7000.0, lat.shape)
    for rr, tr in ((None, None), (r, _t(r))):
        for g, w in zip(tt.spherical_to_cartesian(tr, _t(lat), _t(lon)),
                        jt.spherical_to_cartesian(rr, lat, lon)):
            _close(g, w, 7000.0)


@pytest.mark.parametrize("with_radius", [True, False])
def test_cartesian_to_spherical(with_radius):
    v = _vecs()
    got = tt.cartesian_to_spherical(*_t(v).unbind(-1), with_radius=with_radius)
    want = jt.cartesian_to_spherical(v[:, 0], v[:, 1], v[:, 2],
                                     with_radius=with_radius)
    assert len(got) == len(want) == (3 if with_radius else 2)
    for g, w in zip(got, want):
        _close(g, w, 7000.0 if with_radius else 1.0)
    # the zero vector is defined: lat = lon = 0
    assert float(got[-1][-1]) == 0.0 and float(got[-2][-1]) == 0.0


def test_apply_rotation_and_vecs():
    v, m = _vecs(), _rot()
    for g, w in zip(tt.apply_rotation(m, *_t(v).unbind(-1)),
                    jt.apply_rotation(m, v[:, 0], v[:, 1], v[:, 2])):
        _close(g, w, 7000.0)
    _close(tt.apply_rotation_vecs(m, _t(v)), jt.apply_rotation_vecs(m, v),
           7000.0)
    # a tensor matrix is taken as it is
    _close(tt.apply_rotation_vecs(_t(m), _t(v)), jt.apply_rotation_vecs(m, v),
           7000.0)
    # batched shape
    vb = _t(v[:198]).reshape(2, 9, 11, 3)
    assert torch.equal(tt.apply_rotation_vecs(m, vb).reshape(-1, 3),
                       tt.apply_rotation_vecs(m, _t(v[:198])))


def test_apply_rotation_vecs_float32_has_no_tf32_sized_error():
    """float32 in, float32 out, and equal to the float64 rotation within
    float32 rounding: < 1e-6 relative (TF32 would give ~1e-3)."""
    v, m = _vecs(), _rot()
    got = tt.apply_rotation_vecs(m, torch.as_tensor(v, dtype=torch.float32))
    assert got.dtype == torch.float32
    want = tt.apply_rotation_vecs(m, _t(v))
    assert float((got.double() - want).abs().max()) < 1e-6 * 7000.0
    assert tt.geo_to_mlat_mlt(torch.as_tensor(v, dtype=torch.float32),
                              m)[0].dtype == torch.float32


def test_mlt_sm_lon_pair():
    x = np.random.default_rng(4).uniform(-180.0, 180.0, 100)
    _close(tt.sm_lon_to_mlt(_t(x)), jt.sm_lon_to_mlt(x), 24.0)
    h = np.random.default_rng(5).uniform(0.0, 24.0, 100)
    _close(tt.mlt_to_sm_lon(_t(h)), jt.mlt_to_sm_lon(h), 180.0)
    # numpy passes through (convert_mapping_to_sm's use)
    np.testing.assert_array_equal(tt.mlt_to_sm_lon(h), jt.mlt_to_sm_lon(h))


def test_j2000_to_latlon_and_back():
    v = _vecs()
    fm, jfm = FrameMatrices(T0), JFrameMatrices(T0)
    np.testing.assert_array_equal(fm.j2000_to_geo, jfm.j2000_to_geo)
    lat, lon = tt.j2000_to_latlon(_t(v), fm.j2000_to_geo)
    jlat, jlon = jt.j2000_to_latlon(v, jfm.j2000_to_geo)
    _close(lat, jlat, 90.0)
    # the zero vector has NaN latitude in both; its longitude is atan2 of
    # two signed zeros and means nothing
    assert np.isnan(lat.numpy()[-1])
    ok = ~np.isnan(np.asarray(jlat))
    _close(lon[ok], np.asarray(jlon)[ok], 180.0)
    h = np.random.default_rng(6).uniform(0.0, 500.0, ok.sum())
    back = tt.latlon_to_j2000(lat[ok], lon[ok], _t(h), fm.j2000_to_geo)
    _close(back, jt.latlon_to_j2000(np.asarray(jlat)[ok], np.asarray(jlon)[ok],
                                    h, jfm.j2000_to_geo), 7000.0)


def test_j2000_and_geo_to_mlat_mlt():
    v = _vecs()
    fm, jfm = FrameMatrices(T0), JFrameMatrices(T0)
    for name in ("j2000_to_sm", "geo_to_sm"):
        fn = "j2000_to_mlat_mlt" if name.startswith("j2000") else \
            "geo_to_mlat_mlt"
        got = getattr(tt, fn)(_t(v), getattr(fm, name))
        want = getattr(jt, fn)(v, getattr(jfm, name))
        _close(got[0], want[0], 90.0)
        _close(got[1], want[1], 24.0)


def test_geodetic_height():
    lat, lon = _angles()
    h = np.random.default_rng(7).uniform(-5.0, 800.0, lat.shape)
    x, y, z = (np.asarray(a) for a in jt.geodetic_to_ecef(lat, lon, h))
    got = tt.geodetic_height(_t(x), _t(y), _t(z), _t(lat))
    _close(got, jt.geodetic_height(x, y, z, lat), 7000.0)
    np.testing.assert_allclose(got.numpy(), h, rtol=0, atol=1e-8)


@pytest.mark.parametrize("altitude", [0.0, 110.0])
def test_sm_to_latlon(altitude):
    lat, lon = _angles(8)
    fm, jfm = FrameMatrices(T0), JFrameMatrices(T0)
    la, lo = np.rad2deg(lat), np.rad2deg(lon)
    got = tt.sm_to_latlon(_t(la), _t(lo), fm.sm_to_geo, altitude=altitude)
    want = jt.sm_to_latlon(la, lo, jfm.sm_to_geo, altitude=altitude)
    _close(got[0], want[0], 90.0)
    _close(got[1], want[1], 180.0)


def test_sm_to_latlon_inverts_geo_to_mlat_mlt_at_altitude():
    """sm_to_latlon o geo_to_mlat_mlt at 110 km: within 1e-9 deg."""
    rng = np.random.default_rng(9)
    lat = _t(rng.uniform(-89.0, 89.0, 300))
    lon = _t(rng.uniform(-180.0, 180.0, 300))
    fm = FrameMatrices(T0)
    x, y, z = tt.geodetic_to_ecef(torch.deg2rad(lat), torch.deg2rad(lon),
                                  110.0)
    mlat, mlt = tt.geo_to_mlat_mlt(torch.stack([x, y, z], -1), fm.geo_to_sm)
    la, lo = tt.sm_to_latlon(mlat, tt.mlt_to_sm_lon(mlt), fm.sm_to_geo,
                             altitude=110.0)
    assert float((la - lat).abs().max()) < 1e-9
    dlo = tt.wrap_longitude(lo - lon)
    assert float((dlo.abs() * torch.cos(torch.deg2rad(lat))).max()) < 1e-9


def test_wrap_longitude():
    x = np.concatenate([np.random.default_rng(10).uniform(-900, 900, 100),
                        [180.0, -180.0, 540.0, 0.0, 179.999999]])
    _close(tt.wrap_longitude(_t(x)), jt.wrap_longitude(x), 180.0)
    assert float(tt.wrap_longitude(_t([180.0]))[0]) == -180.0
    with pytest.raises(TypeError):  # tensors only: an array is refused
        tt.wrap_longitude(x)


def test_unit_vectors_and_angle_between():
    v = _vecs()[:-1]  # the zero vector has no direction
    w = _vecs(11)[:-1]
    u = tt.unit_vectors(_t(v))
    _close(u, jt.unit_vectors(v))
    uw = tt.unit_vectors(_t(w))
    _close(tt.angle_between(u, uw), jt.angle_between(u.numpy(), uw.numpy()))
    # clipped: a vector with itself is exactly 0, with its negative pi
    assert float(tt.angle_between(u, u).max()) < 3e-8
    assert float((tt.angle_between(u, -u) - np.pi).abs().max()) < 3e-8
    # another axis
    _close(tt.unit_vectors(_t(v).T, dim=0), jt.unit_vectors(v.T, axis=0))


def test_rotate_pole_uses_the_module_rotation():
    lat, lon = _angles(12)
    lat = lat[:200]
    lon = lon[:200]
    got = tt.rotate_pole(_t(lat), _t(lon), 110.0, angle_deg=-90.0)
    want = jt.rotate_pole(lat, lon, 110.0, angle_deg=-90.0)
    _close(got[0], want[0])
    _close(got[1], want[1], np.pi)

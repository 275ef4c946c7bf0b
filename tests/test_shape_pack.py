"""Packed-variant store (io/shape_pack.py): round-trip, gather-path
bit-identity vs the decode path, and the engine's decode-free reuse."""

import numpy as np
import pytest
from PIL import Image

from colormipsearch_tpu.engine.cds import CDSParams
from colormipsearch_tpu.engine.gradscore import GradScoreEngine
from colormipsearch_tpu.io.shape_pack import (
    ShapePackStore,
    build_row_fields,
    file_identity,
)
from colormipsearch_tpu.model import CDMatch, ComputeFileType
from colormipsearch_tpu.model.entities import FileData, Neuron
from colormipsearch_tpu.ops import shape_score
from colormipsearch_tpu.oracle.shape import dilate_rgb, mask_rgb


def _mk_cdm(rng, h, w, n):
    img = np.zeros((h, w, 3), np.uint8)
    ys = rng.integers(0, h, n)
    xs = rng.integers(0, w, n)
    img[ys, xs] = rng.integers(0, 256, (n, 3))
    return img


def test_store_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    h, w = 40, 50
    store = ShapePackStore(tmp_path / "s", h, w)
    zsl = rng.integers(0, 257, h * w).astype(np.uint16)
    grad = rng.integers(0, 400, h * w).astype(np.uint16)
    tfg = rng.integers(0, 256, -(-h * w // 8)).astype(np.uint8)
    key = store.entry_key(cdm_id="a|1|2", grad_id="b|1|2", zgap_id="c|1|2",
                          mask_threshold=20)
    assert store.lookup(key) is None
    row = store.append(key, zsl, grad, tfg)
    assert store.append(key, zsl, grad, tfg) == row  # idempotent
    assert store.lookup(key) == row
    z2, g2, t2 = store.row(row)
    np.testing.assert_array_equal(z2, zsl)
    np.testing.assert_array_equal(g2, grad)
    np.testing.assert_array_equal(t2, tfg)

    # a fresh handle reloads the index and data
    store2 = ShapePackStore(tmp_path / "s", h, w)
    assert store2.lookup(key) == row
    np.testing.assert_array_equal(store2.row(row)[0], zsl)

    # mismatched geometry is rejected
    with pytest.raises(ValueError):
        ShapePackStore(tmp_path / "s", h, w + 1)


@pytest.mark.parametrize("mirror", [True, False])
def test_row_gather_equals_decode_select(mirror):
    """select_target_cols_split_from_row must be bit-identical to
    select_target_cols_split on the same images."""
    rng = np.random.default_rng(5)
    h, w = 48, 64
    t_rgb = _mk_cdm(rng, h, w, 700)
    grad = rng.integers(0, 300, (h, w)).astype(np.uint16)
    zgap = dilate_rgb(mask_rgb(t_rgb, 20), 8)
    region = np.zeros((h, w), bool)
    region[:5, :10] = True

    q_rgb = _mk_cdm(rng, h, w, 300)
    q_pack = shape_score.pack_query(q_rgb, excluded_region=region)
    pos_gap, pos_he = shape_score.support_split(q_pack)
    n_gap = shape_score.support_bucket(pos_gap.size, minimum=64)
    n_he = shape_score.he_words(pos_he.size, minimum=8)

    want = shape_score.select_target_cols_split(
        t_rgb, grad, zgap, pos_gap, n_gap, pos_he, n_he,
        mask_threshold=20, excluded=region, mirror=mirror)

    zsl, grad_thr, tfg_bits = build_row_fields(
        t_rgb, grad, zgap, mask_threshold=20)
    plan = shape_score.split_gather_plan(
        pos_gap, pos_he, w, mirror=mirror, excluded=region)
    got = shape_score.select_target_cols_split_from_row(
        zsl, grad_thr, tfg_bits, pos_gap, n_gap, n_he, plan,
        mirror=mirror)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_file_identity(tmp_path):
    p = tmp_path / "x.png"
    assert file_identity(FileData(str(p))) is None
    p.write_bytes(b"abc")
    ident = file_identity(FileData(str(p)))
    assert str(p) in ident and "|3|" in ident
    assert file_identity(FileData(str(p), "entry")) != ident


@pytest.mark.parametrize("with_zgap", [True, False])
def test_engine_reuses_store_without_decoding(tmp_path, monkeypatch,
                                              with_zgap):
    """Second engine run with the same store must produce identical
    scores WITHOUT touching the image loader (the decode-once claim),
    for both the zgap-variant and dilation-fallback rows."""
    rng = np.random.default_rng(9)
    h, w = 60, 80
    mask_img = _mk_cdm(rng, h, w, 400)
    Image.fromarray(mask_img).save(tmp_path / "mask.png")
    mask_neuron = Neuron(mip_id="mask-1")
    mask_neuron.set_compute_file(
        ComputeFileType.InputColorDepthImage, str(tmp_path / "mask.png"))

    def mk_matches():
        out = []
        for i in range(4):
            target = Neuron(mip_id=f"t-{i}")
            target.set_compute_file(
                ComputeFileType.InputColorDepthImage,
                str(tmp_path / f"t{i}.png"))
            target.set_compute_file(
                ComputeFileType.GradientImage,
                str(tmp_path / f"t{i}_grad.png"))
            if with_zgap:
                target.set_compute_file(
                    ComputeFileType.ZGapImage,
                    str(tmp_path / f"t{i}_zgap.png"))
            out.append(CDMatch(mask_image=mask_neuron,
                               matched_image=target,
                               matching_pixels=40 + i))
        return out

    for i in range(4):
        t_img = _mk_cdm(rng, h, w, 500)
        Image.fromarray(t_img).save(tmp_path / f"t{i}.png")
        Image.fromarray(
            rng.integers(0, 300, (h, w)).astype(np.uint16)).save(
            tmp_path / f"t{i}_grad.png")
        if with_zgap:
            Image.fromarray(dilate_rgb(mask_rgb(t_img, 20), 20)).save(
                tmp_path / f"t{i}_zgap.png")

    params = CDSParams(mask_threshold=20, data_threshold=20,
                       mirror_mask=True, negative_radius=20)
    store_dir = str(tmp_path / "pack")
    first = mk_matches()
    engine = GradScoreEngine(params, use_device=True,
                             pack_store=store_dir)
    assert len(engine.score_matches(first)) == 4
    assert engine._pack_store.misses == 4 and engine._pack_store.hits == 0

    # second run: poison the image cache loader — any decode attempt on
    # a TARGET now fails (the mask itself still loads)
    from colormipsearch_tpu.io import cache as mips_cache

    def boom(neuron, ftype):
        raise AssertionError(
            f"decode of {neuron.mip_id}/{ftype} despite packed store")

    monkeypatch.setattr(mips_cache, "load_mip", boom)
    second = mk_matches()
    engine2 = GradScoreEngine(params, use_device=True,
                              pack_store=store_dir)
    assert len(engine2.score_matches(second)) == 4
    assert engine2._pack_store.hits == 4
    for a, b in zip(first, second):
        assert b.gradient_area_gap == a.gradient_area_gap
        assert b.high_expression_area == a.high_expression_area
        assert b.normalized_score == a.normalized_score


def test_engine_device_store_flag_equals_host(tmp_path, monkeypatch):
    """GradScoreEngine with CDS_SHAPE_STORE_DEVICE=1 must produce
    identical scores to the host tile-pack path on a store-hit run."""
    rng = np.random.default_rng(23)
    h, w = 60, 80
    mask_img = _mk_cdm(rng, h, w, 400)
    Image.fromarray(mask_img).save(tmp_path / "mask.png")
    mask_neuron = Neuron(mip_id="mask-1")
    mask_neuron.set_compute_file(
        ComputeFileType.InputColorDepthImage, str(tmp_path / "mask.png"))

    def mk_matches():
        out = []
        for i in range(5):
            target = Neuron(mip_id=f"t-{i}")
            for suffix, ftype in (
                    ("", ComputeFileType.InputColorDepthImage),
                    ("_grad", ComputeFileType.GradientImage),
                    ("_zgap", ComputeFileType.ZGapImage)):
                target.set_compute_file(
                    ftype, str(tmp_path / f"t{i}{suffix}.png"))
            out.append(CDMatch(mask_image=mask_neuron,
                               matched_image=target,
                               matching_pixels=40 + i))
        return out

    for i in range(5):
        t_img = _mk_cdm(rng, h, w, 500)
        Image.fromarray(t_img).save(tmp_path / f"t{i}.png")
        Image.fromarray(
            rng.integers(0, 300, (h, w)).astype(np.uint16)).save(
            tmp_path / f"t{i}_grad.png")
        Image.fromarray(dilate_rgb(mask_rgb(t_img, 20), 20)).save(
            tmp_path / f"t{i}_zgap.png")

    params = CDSParams(mask_threshold=20, data_threshold=20,
                       mirror_mask=True, negative_radius=20)
    store_dir = str(tmp_path / "pack")
    # build pass (host path) populates the store
    first = mk_matches()
    GradScoreEngine(params, use_device=True,
                    pack_store=store_dir).score_matches(first)
    # host store-hit reference
    ref = mk_matches()
    GradScoreEngine(params, use_device=True,
                    pack_store=store_dir).score_matches(ref)
    # device-resident store path
    monkeypatch.setenv("CDS_SHAPE_STORE_DEVICE", "1")
    got = mk_matches()
    eng = GradScoreEngine(params, use_device=True,
                          pack_store=store_dir)
    eng.score_matches(got)
    assert getattr(eng, "_dev_store_cache", None) is not None
    for a, b in zip(ref, got):
        assert b.gradient_area_gap == a.gradient_area_gap
        assert b.high_expression_area == a.high_expression_area
        assert b.normalized_score == a.normalized_score


@pytest.mark.parametrize("mirror", [True, False])
def test_tile_gather_equals_row_path(tmp_path, mirror):
    """The engine's tile fast lane (one vectorized gather per field)
    must equal the per-row gather path assembled target by target."""
    rng = np.random.default_rng(11)
    h, w = 40, 56
    store = ShapePackStore(tmp_path / "s", h, w)
    rows = []
    per_target = []
    q_rgb = _mk_cdm(rng, h, w, 260)
    region = np.zeros((h, w), bool)
    region[: h // 4, : w // 3] = True
    q_pack = shape_score.pack_query(q_rgb, excluded_region=region)
    pos_gap, pos_he = shape_score.support_split(q_pack)
    n_gap = shape_score.support_bucket(pos_gap.size, minimum=64)
    n_he = shape_score.he_words(pos_he.size, minimum=8)
    plan = shape_score.split_gather_plan(
        pos_gap, pos_he, w, mirror=mirror, excluded=region)
    for i in range(7):
        t_rgb = _mk_cdm(rng, h, w, 500)
        grad = rng.integers(0, 300, (h, w)).astype(np.uint16)
        zgap = dilate_rgb(mask_rgb(t_rgb, 20), 6)
        fields = build_row_fields(t_rgb, grad, zgap, mask_threshold=20)
        rows.append(store.append(f"k{i}", *fields))
        per_target.append(shape_score.select_target_cols_split_from_row(
            *fields, pos_gap, n_gap, n_he, plan, mirror=mirror))
    want = shape_score.assemble_target_rows_split(
        per_target, n_gap, n_he, mirror=mirror)
    got = shape_score.select_target_tile_from_store(
        store, rows, pos_gap, n_gap, n_he, plan, mirror=mirror)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("with_region", [True, False])
def test_device_shape_tile_equals_host(tmp_path, mirror, with_region):
    """The device-resident store path (device_store_fields +
    shape_tile_device, the round-5 wire rung) must be bit-identical to
    select_target_tile_from_store on the same rows."""
    import jax.numpy as jnp

    rng = np.random.default_rng(19)
    h, w = 37, 53
    store = ShapePackStore(tmp_path / "s", h, w)
    q_rgb = _mk_cdm(rng, h, w, 240)
    region = None
    if with_region:
        region = np.zeros((h, w), bool)
        region[: h // 3, : w // 4] = True
    q_pack = shape_score.pack_query(q_rgb, excluded_region=region)
    pos_gap, pos_he = shape_score.support_split(q_pack)
    n_gap = shape_score.support_bucket(pos_gap.size, minimum=64)
    n_he = shape_score.he_words(pos_he.size, minimum=4)
    plan = shape_score.split_gather_plan(
        pos_gap, pos_he, w, mirror=mirror, excluded=region)
    rows = []
    for i in range(6):
        t_rgb = _mk_cdm(rng, h, w, 420)
        grad = rng.integers(0, 300, (h, w)).astype(np.uint16)
        zgap = dilate_rgb(mask_rgb(t_rgb, 20), 6)
        rows.append(store.append(
            f"k{i}", *build_row_fields(t_rgb, grad, zgap,
                                       mask_threshold=20)))
    want = shape_score.select_target_tile_from_store(
        store, rows, pos_gap, n_gap, n_he, plan, mirror=mirror)
    g_pos, h_pos, keep_he = plan
    fields = shape_score.device_store_fields(store)
    got = shape_score.shape_tile_device(
        fields, rows, pos_gap, g_pos, h_pos, keep_he,
        n_gap_pad=n_gap, n_he_words=n_he, mirror=mirror)
    np.testing.assert_array_equal(np.asarray(got[0]), want[0])
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])
    # subset upload: rows become local indices
    sub = [rows[4], rows[1], rows[2]]
    fields_sub = shape_score.device_store_fields(store, rows=sub)
    got2 = shape_score.shape_tile_device(
        fields_sub, np.arange(3), pos_gap, g_pos, h_pos, keep_he,
        n_gap_pad=n_gap, n_he_words=n_he, mirror=mirror)
    want2 = shape_score.select_target_tile_from_store(
        store, sub, pos_gap, n_gap, n_he, plan, mirror=mirror)
    np.testing.assert_array_equal(np.asarray(got2[0]), want2[0])
    np.testing.assert_array_equal(np.asarray(got2[1]), want2[1])


def test_field_maps_refresh_after_growth(tmp_path):
    """Regression (ADVICE r3, high): after the store grows, EVERY field
    mmap must be refreshed — a shared mapped-rows counter left grad/tfg
    stale (shapes [6, 3, 3]) and the native tile pack then read past the
    mapped region for rows appended after the first map."""
    rng = np.random.default_rng(21)
    h, w = 8, 8
    store = ShapePackStore(tmp_path / "s", h, w)

    def mk(i):
        zsl = rng.integers(0, 257, h * w).astype(np.uint16)
        grad = rng.integers(0, 400, h * w).astype(np.uint16)
        tfg = rng.integers(0, 256, -(-h * w // 8)).astype(np.uint8)
        return store.append(f"k{i}", zsl, grad, tfg), (zsl, grad, tfg)

    kept = {}
    for i in range(3):
        row, fields = mk(i)
        kept[row] = fields
    maps = store.field_maps()
    assert [m.shape[0] for m in maps] == [3, 3, 3]
    for i in range(3, 6):
        row, fields = mk(i)
        kept[row] = fields
    maps = store.field_maps()
    assert [m.shape[0] for m in maps] == [6, 6, 6]
    for row, (zsl, grad, tfg) in kept.items():
        np.testing.assert_array_equal(maps[0][row], zsl)
        np.testing.assert_array_equal(maps[1][row], grad)
        np.testing.assert_array_equal(maps[2][row], tfg)


def test_native_build_row_fields_equals_numpy(monkeypatch):
    """build_row_fields' native one-pass twin must be bit-identical to
    the numpy path across the full uint8 RGB range, threshold edges, and
    a pixel count that is not a multiple of 8 (tail byte zero-padding
    like np.packbits)."""
    from colormipsearch_tpu.io import native_decoder

    if not native_decoder.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(17)
    h, w = 33, 41  # 1353 px: not a multiple of 8
    t_rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    # force threshold-boundary values into the foreground test
    t_rgb[0, :3] = (20, 20, 20)
    t_rgb[0, 3:6] = (21, 20, 20)
    grad = rng.integers(0, 1 << 16, (h, w), dtype=np.uint16)
    from colormipsearch_tpu.ops.shape_score import GAP_THRESHOLD
    grad[1, 0] = GAP_THRESHOLD
    grad[1, 1] = GAP_THRESHOLD + 1
    zgap = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    native = build_row_fields(t_rgb, grad, zgap, mask_threshold=20)
    monkeypatch.setattr(native_decoder, "available", lambda: False)
    ref = build_row_fields(t_rgb, grad, zgap, mask_threshold=20)
    for a, b in zip(native, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("with_region", [True, False])
def test_native_tile_pack_equals_numpy(tmp_path, monkeypatch, mirror,
                                       with_region):
    """The threaded native tile pack (cdm_shape_tile_from_store) must be
    bit-identical to the numpy gather path it replaces, across
    orientations, region gating, and a support size that is not a
    multiple of 32 (exercises the tail-word packing)."""
    from colormipsearch_tpu.io import native_decoder

    if not native_decoder.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(13)
    h, w = 37, 53
    store = ShapePackStore(tmp_path / "s", h, w)
    q_rgb = _mk_cdm(rng, h, w, 240)
    region = None
    if with_region:
        region = np.zeros((h, w), bool)
        region[: h // 3, : w // 4] = True
    q_pack = shape_score.pack_query(q_rgb, excluded_region=region)
    pos_gap, pos_he = shape_score.support_split(q_pack)
    n_gap = shape_score.support_bucket(pos_gap.size, minimum=64)
    n_he = shape_score.he_words(pos_he.size, minimum=4)
    plan = shape_score.split_gather_plan(
        pos_gap, pos_he, w, mirror=mirror, excluded=region)
    rows = []
    for i in range(5):
        t_rgb = _mk_cdm(rng, h, w, 420)
        grad = rng.integers(0, 300, (h, w)).astype(np.uint16)
        zgap = dilate_rgb(mask_rgb(t_rgb, 20), 6)
        rows.append(store.append(
            f"k{i}", *build_row_fields(t_rgb, grad, zgap,
                                       mask_threshold=20)))
    native = shape_score.select_target_tile_from_store(
        store, rows, pos_gap, n_gap, n_he, plan, mirror=mirror)
    monkeypatch.setattr(native_decoder, "available", lambda: False)
    ref = shape_score.select_target_tile_from_store(
        store, rows, pos_gap, n_gap, n_he, plan, mirror=mirror)
    np.testing.assert_array_equal(native[0], ref[0])
    np.testing.assert_array_equal(native[1], ref[1])


def test_upload_pixel_major_chunked_equals_direct():
    """The chunked device upload (<=256 MB slices) must
    place bit-identical pixel-major fields; force multi-chunk with a
    tiny chunk_bytes."""
    import numpy as np

    from colormipsearch_tpu.ops import shape_score

    rng = np.random.default_rng(0)
    field = rng.integers(0, 1 << 16, (7, 1003), dtype=np.uint16)
    direct = np.asarray(shape_score._upload_pixel_major(field))
    chunked = np.asarray(shape_score._upload_pixel_major(
        field, chunk_bytes=4096))
    assert np.array_equal(direct, field.T)
    assert np.array_equal(chunked, field.T)


def test_device_store_growth_pins_fields(tmp_path, monkeypatch):
    """When the store GROWS after the one-time field upload (the
    build-interleaved scenario), the fields stay pinned — no multi-GB
    re-upload — and the newer rows are served by the host tile pack
    with identical scores (round-5 fix: re-uploading per growth
    measured ~80 s every few masks on the real production grad pass)."""
    from colormipsearch_tpu.utils.metrics import GLOBAL

    rng = np.random.default_rng(31)
    h, w = 60, 80
    mask_img = _mk_cdm(rng, h, w, 400)
    Image.fromarray(mask_img).save(tmp_path / "mask.png")
    mask_neuron = Neuron(mip_id="mask-1")
    mask_neuron.set_compute_file(
        ComputeFileType.InputColorDepthImage, str(tmp_path / "mask.png"))

    def mk_match(i):
        target = Neuron(mip_id=f"t-{i}")
        for suffix, ftype in (
                ("", ComputeFileType.InputColorDepthImage),
                ("_grad", ComputeFileType.GradientImage),
                ("_zgap", ComputeFileType.ZGapImage)):
            target.set_compute_file(
                ftype, str(tmp_path / f"t{i}{suffix}.png"))
        return CDMatch(mask_image=mask_neuron, matched_image=target,
                       matching_pixels=40 + i)

    for i in range(6):
        t_img = _mk_cdm(rng, h, w, 500)
        Image.fromarray(t_img).save(tmp_path / f"t{i}.png")
        Image.fromarray(
            rng.integers(0, 300, (h, w)).astype(np.uint16)).save(
            tmp_path / f"t{i}_grad.png")
        Image.fromarray(dilate_rgb(mask_rgb(t_img, 20), 20)).save(
            tmp_path / f"t{i}_zgap.png")

    params = CDSParams(mask_threshold=20, data_threshold=20,
                       mirror_mask=True, negative_radius=20)
    store_dir = str(tmp_path / "pack")
    # seed the store with targets 0-2 only
    GradScoreEngine(params, use_device=True,
                    pack_store=store_dir).score_matches(
        [mk_match(i) for i in range(3)])

    # host-path reference over ALL 6 targets (fresh engine)
    ref = [mk_match(i) for i in range(6)]
    GradScoreEngine(params, use_device=True,
                    pack_store=store_dir).score_matches(ref)

    # device-store engine: first call uploads fields for rows 0-2;
    # second call sees rows 3-5 appended (store grew) — fields must
    # stay pinned (ONE upload) and scores must still match
    monkeypatch.setenv("CDS_SHAPE_STORE_DEVICE", "1")
    eng = GradScoreEngine(params, use_device=True,
                          pack_store=store_dir)
    got_a = [mk_match(i) for i in range(3)]
    eng.score_matches(got_a)
    up1 = GLOBAL.get("gs.storeUploadBytes")
    got_b = [mk_match(i) for i in range(6)]
    eng.score_matches(got_b)  # rows 3-5 miss -> decode+append (grow)
    got_c = [mk_match(i) for i in range(6)]
    eng.score_matches(got_c)  # all 6 hit; 3 are past the pinned count
    assert GLOBAL.get("gs.storeUploadBytes") == up1, \
        "store growth must not re-upload the device fields"
    for a, b in zip(ref, got_c):
        assert b.gradient_area_gap == a.gradient_area_gap
        assert b.high_expression_area == a.high_expression_area

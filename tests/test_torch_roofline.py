"""The port's grid and roofline arithmetic (``repro_torch.launch.cells``,
``repro_torch.analysis.roofline``) against the JAX package's
(``repro.launch.cells``, ``repro.analysis.roofline``): the same cells and
skips, parameter counts, model FLOPs and HBM bytes for every (arch,
shape), and the same roofline terms under the reference's figures."""
import dataclasses

import pytest

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import list_archs as ref_list_archs

ref_list_archs()        # fill the reference's registry before anything else

import repro.analysis.roofline as ref_roofline  # noqa: E402
import repro.launch.cells as ref_cells  # noqa: E402

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config, list_archs  # noqa
from repro_torch.launch import cells  # noqa: E402

ARCHS = ref_list_archs()
MESHES = [{}, {"data": 1}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}, {"data": 256, "model": 2}]


def test_cells_and_skips_equal_the_reference():
    assert list_archs() == ARCHS
    assert cells.LONG_OK == ref_cells.LONG_OK
    assert cells.NO_DECODE == ref_cells.NO_DECODE
    assert cells.cell_list() == ref_cells.cell_list()
    assert cells.cell_skips() == ref_cells.cell_skips()
    assert len(cells.cell_list()) == len(ARCHS) * 4 - len(cells.cell_skips())


def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert roofline.param_counts(cfg) == ref_roofline._param_counts(ref_cfg)
    for name in SHAPES:
        assert roofline.model_flops(cfg, SHAPES[name]) == \
            ref_roofline.model_flops(ref_cfg, REF_SHAPES[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_hbm_bytes_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name in SHAPES:
        for mesh in MESHES:
            assert roofline.analytic_hbm_bytes(cfg, SHAPES[name], mesh) == \
                ref_roofline.analytic_hbm_bytes(ref_cfg, REF_SHAPES[name],
                                                mesh), (name, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_terms_equal_the_reference_under_v5e(arch):
    assert roofline.HW_V5E == ref_roofline.HW_V5E
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name in SHAPES:
        for mesh in MESHES[1:3]:
            n_dev = 1
            for v in mesh.values():
                n_dev *= v
            flops = roofline.model_flops(cfg, SHAPES[name]) * 4 / 3 / n_dev
            nbytes = roofline.analytic_hbm_bytes(cfg, SHAPES[name], mesh)
            coll = nbytes / 7.0
            kw = dict(n_devices=n_dev, model_total_flops=roofline.model_flops(
                cfg, SHAPES[name]))
            got = roofline.roofline_terms(flops, nbytes, coll,
                                          hw=roofline.HW_V5E, **kw)
            want = ref_roofline.roofline_terms(flops, nbytes, coll, **kw)
            assert got.to_dict() == want.to_dict(), (name, mesh)


def test_one_card_terms_use_the_h100_figures():
    cfg = get_config("stablelm-1.6b")
    shape = SHAPES["train_4k"]
    flops = roofline.model_flops(cfg, shape)
    nbytes = roofline.analytic_hbm_bytes(cfg, shape, {})
    t = roofline.roofline_terms(flops, nbytes, 0.0, n_devices=1,
                                model_total_flops=flops)
    assert t.compute_s == flops / 989e12 and t.memory_s == nbytes / 3.35e12
    assert t.collective_s == 0.0 and t.bottleneck == "compute"
    assert t.useful_ratio == 1.0 and t.peak_fraction == pytest.approx(1.0)
    # decode at one token a sequence is bound by the bytes
    dec = SHAPES["decode_32k"]
    t = roofline.roofline_terms(
        roofline.model_flops(cfg, dec),
        roofline.analytic_hbm_bytes(cfg, dec, {}), 0.0, n_devices=1,
        model_total_flops=roofline.model_flops(cfg, dec))
    assert t.bottleneck == "memory" and t.peak_fraction < 0.05


@pytest.mark.parametrize("name,size", [("float32", 4), ("bfloat16", 2),
                                       ("float16", 2), ("int8", 1)])
def test_dtype_size(name, size):
    assert roofline.dtype_size(name) == size

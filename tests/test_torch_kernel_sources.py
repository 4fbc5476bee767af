"""What the recurrence kernels' sources promise, checked where no compiler
runs: the WKV kernel's decay factors are products of w (it calls neither
exp nor log), the RG-LRU kernel keeps the plain version's step order,
``chip_smoke.py`` names each kernel instance by its template arguments, and
every design ``recurrence_ab.py`` and ``backward_ab.py`` time against
them is still an edit of today's sources.  The kernels themselves are held
to their plain versions on the card (``tests/test_torch_cuda.py``)."""
import importlib.util
import re
from pathlib import Path

import pytest

from repro_torch.kernels import backward_ab, recurrence_ab
from repro_torch.kernels.rglru_scan.ops import SOURCE as RG_SOURCE
from repro_torch.kernels.rwkv6_wkv.ops import SOURCE as WKV_SOURCE

ROOT = Path(__file__).resolve().parents[1]


def _code(path: Path) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_wkv_kernel_calls_neither_exp_nor_log():
    calls = re.findall(r"\b(?:__)?(?:exp|log)(?:2|10|1p|m1)?f?\s*\(",
                       _code(WKV_SOURCE))
    assert calls == []
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in \
        WKV_SOURCE.read_text()


def test_rglru_kernel_keeps_the_plain_step_order():
    code = _code(RG_SOURCE)
    assert "__fadd_rn(__fmul_rn(a, h), b)" in code
    assert "fmaf" not in code and "cp.async.cg.shared.global" in code


@pytest.mark.parametrize("mangled,name", [
    ("_ZN44_GLOBAL__N__20f14e81_12_rwkv6_wkv_cu_wkv_fwd22wkv_fwd_chunked_"
     "kernelINS_3CfgI13__nv_bfloat16Li64ELi64ELi32ELi16ELi4EEEEEvPKNT_1EE",
     "wkv_fwd_chunked_kernel<bf16, 64, 64, 32, 16, 4>"),
    ("_ZN12_GLOBAL__N_122rglru_scan_ring_kernelIfNS_4RingIfLi64ELi2ELi32EE"
     "EEEvPKT_S5_PS3_Pfii", "rglru_scan_ring_kernel<float, 64, 2, 32>"),
    ("_ZN12_GLOBAL__N_122rglru_scan_rows_kernelI13__nv_bfloat16EEvPKT_",
     "rglru_scan_rows_kernel<bf16>"),
    ("_ZN2tc16fa_fwd_tc_kernelILi4EEEvPK", "fa_fwd_tc_kernel<4>"),
    ("_ZN44_GLOBAL__N__20f14e81_12_rwkv6_wkv_cu_wkv_fwd14wkv_bwd_kernelINS_"
     "6BwdCfgIfLi64ELi32EEEEEvPKNT_1EES6_S6_PKfS6_S6_S8_PS4_S9_S9_PfSA_SA_"
     "ii", "wkv_bwd_kernel<float, 64, 32>"),
    ("_ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_891661312tc21fa_bwd_"
     "dkdv256_kernelE14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_NS_"
     "5ShapeE", "fa_bwd_dkdv256_kernel"),
])
def test_build_lines_name_each_instance(mangled, name):
    assert _chip_smoke().kernel_name(mangled) == name


@pytest.mark.parametrize("kernel,design", sorted(recurrence_ab.EDITS))
def test_each_timed_design_is_an_edit_of_the_source(kernel, design):
    shipped = (WKV_SOURCE if kernel == "wkv" else RG_SOURCE).read_text()
    text = recurrence_ab.design_source(kernel, design)
    assert text != shipped
    for _, _, new in recurrence_ab.EDITS[(kernel, design)]:
        assert new in text


@pytest.mark.parametrize("kernel,design", sorted(backward_ab.EDITS))
def test_each_timed_backward_design_is_an_edit_of_the_source(kernel,
                                                              design):
    shipped = backward_ab._SOURCES[kernel].read_text()
    text = backward_ab.design_source(kernel, design)
    assert text != shipped
    for _, _, new in backward_ab.EDITS[(kernel, design)]:
        assert new in text

"""The attribution tool of the adjoint kernel K3 (``tools/k3_variants.py``):
its substitutions still match the kernel sources once each, and its SASS
reader finds the pair loop."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "k3_variants", ROOT / "tools" / "k3_variants.py")
k3_variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(k3_variants)


@pytest.mark.parametrize("name", sorted(k3_variants.VARIANTS))
def test_variant_substitutions_match_once(name):
    """Each variant changes the sources it names (this tree's text stands
    for the parent's too: the substituted lines are the same in both, or an
    alternative of the variant names this tree's)."""
    changes = k3_variants.resolve(k3_variants.VARIANTS[name], ROOT)
    for file in {c[0] for c in changes}:
        text = (ROOT / file).read_text()
        assert k3_variants.substitute(text, changes, file) != text


def test_pair_loop_is_the_inner_loop_with_one_shared_load():
    sass = """
        Function : _ZN4anon24fused_kde_adjoint_kernelIfdLi0ELi3EEEvv
        /*0000*/                   LDS R1, [R2] ;
        /*0010*/                   FFMA R3, R1, R1, R3 ;
        /*0020*/               @P1 BRA 0x0 ;
        Function : _ZN4anon24fused_kde_adjoint_kernelIffLi0ELi0EEEvv
        /*0000*/                   LDS R1, [R2] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FADD R5, -R4, R6 ;
        /*0030*/                   FFMA.SAT R6, R5, R7, 0.5 ;
        /*0040*/                   FMUL R8, R6, R5 ;
        /*0050*/               @P1 BRA 0x10 ;
        /*0060*/               @P2 BRA 0x0 ;
    """
    ops = k3_variants.pair_loop(sass)
    assert ops == {"LDS": 1, "FADD": 1, "FFMA": 1, "FMUL": 1, "BRA": 1}


def test_sass_diff_names_functions_across_builds():
    """Functions match across two builds (the anonymous namespace, which
    names the build, left out); a changed instruction is reported."""
    a = """
        Function : _ZN53_GLOBAL__N__b13a1edc_20_fused_kde_adjoint_cu_c0605d2024fused_kde_adjoint_kernelIffLi0ELi1EEEvv
        /*0000*/                   LDS R1, [R2] ;   /* 0x000 */
        /*0010*/                   FFMA R3, R1, R1, R3 ;
    """
    b = a.replace("b13a1edc", "4c09d1b9")
    assert k3_variants.sass_diff(a, b) == [
        "24fused_kde_adjoint_kernelIffLi0ELi1EEEvv: 2 | 2 instructions, the same"]
    assert k3_variants.sass_diff(a, b.replace("FFMA R3", "FFMA R4"))[0].endswith("DIFFER")

"""`scripts/render_launch_sweep.py` on the host: its patched copies of
`csrc/render.cu` change the launch geometry and nothing else, and the
script stands alone like the port (no jax, flax, optax, gymnasium or JAX
package import).  The timing itself needs the card and is not run here."""
import difflib
import importlib.util
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "render_launch_sweep.py")


@pytest.fixture(scope="module")
def sweep():
    spec = importlib.util.spec_from_file_location("render_launch_sweep",
                                                  SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def source(sweep):
    with open(os.path.join(sweep._build.CSRC_DIR, sweep.SRC)) as f:
        return f.read()


@pytest.mark.parametrize("threads,pixels", [(64, 1), (128, 2), (256, 8)])
def test_patch_changes_only_the_geometry(sweep, source, threads, pixels):
    text = sweep.patched(source, threads, pixels)
    wanted = {"GPD_RENDER_THREADS": threads, "GPD_RENDER_PIXELS": pixels}
    for name, value in wanted.items():
        assert text.count(f"#define {name} {value}\n") == 1
    changed = [line[1:] for line in difflib.unified_diff(
        source.splitlines(), text.splitlines(), lineterm="", n=0)
        if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    assert all(re.fullmatch(r"#define (GPD_RENDER_THREADS|GPD_RENDER_PIXELS)"
                            r" \d+", line) for line in changed)
    # the shipped geometry is one pair of constants, patched back exactly
    shipped = [int(re.search(rf"#define {name} (\d+)", source).group(1))
               for name in wanted]
    assert sweep.patched(text, *shipped) == source


def test_patch_refuses_a_source_without_the_define(sweep, source):
    with pytest.raises(RuntimeError, match="GPD_RENDER_PIXELS"):
        sweep.patched(source.replace("#define GPD_RENDER_PIXELS",
                                     "#define GPD_RENDER_PX"), 128, 4)


def test_sweep_imports_no_jax():
    forbidden = re.compile(
        r"^\s*(?:import|from)\s+"
        r"(jax|flax|optax|gymnasium|gym_pybullet_drones_tpu)(?![\w])",
        re.MULTILINE)
    with open(SCRIPT) as f:
        assert not forbidden.findall(f.read())


SASS = """
        Function : _Z11other_kernelv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/              @!P0 BRA 0x0 ;
        .....
        Function : _Z13render_kernelPKfiiS0_iiPfiS1_Pii15GpdRenderParams
        /*0000*/                   MOV R1, c[0x0][0x28] ;  /* 0x00000a0000017a02 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   BSSY B0, 0x70 ;
        /*0030*/                   MUFU.RSQ R3, R20 ;
        /*0040*/              @!P0 BRA 0x60 ;
        /*0050*/                   CALL.REL.NOINC 0x90 ;
        /*0060*/                   BSYNC B0 ;
        /*0070*/              @!P1 BRA 0x20 ;
        /*0080*/                   EXIT ;
        /*0090*/                   MUFU.RCP R2, R3 ;
        /*00a0*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_sass_layout_reads_the_render_kernel(sweep):
    layout = sweep.sass_layout(SASS)
    assert layout["instructions"] == 11
    assert layout["bars"] == [1]
    assert layout["kinds"] == {"BAR": 1, "BSSY": 1, "MUFU.RSQ": 1, "BRA": 2,
                               "CALL": 1, "EXIT": 1, "MUFU.RCP": 1,
                               "RET": 1}
    # one backward branch (0x70 -> 0x20); the forward one is no loop
    assert layout["loops"] == [{"span": [2, 7], "size": 6, "kinds": {
        "BSSY": 1, "MUFU.RSQ": 1, "BRA": 2, "CALL": 1}}]
    assert sweep.sass_layout(SASS.split("Function : _Z13")[0]) is None

"""How the port's CUDA sources are built (petals_tpu_torch/kernels/build.py),
on the CPU: no nvcc is needed to name a library or its compiler command.

- A library is keyed by its source, every header in csrc and the flags: an
  edit to a header a source includes (hopper_wgmma.cuh, which both
  attention sources include) gives every library a new path, so a stale
  build is never reused.
- The compiler command puts csrc on the include path, so a modified copy of
  a source built elsewhere (the ablation and fault scripts) finds the
  headers.
- The attention sources and the dequant-matmul source share one copy of
  the wgmma helpers: the header's.
- The ablation and fault scripts find, once each, the source lines they
  edit (a script whose line moved would measure or plant nothing)."""

import importlib.util
import re
import shutil
from pathlib import Path

import pytest

from petals_tpu_torch.kernels import build as kbuild

SOURCES = ("paged_attention", "flash_attention", "quant_matmul")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(kbuild.CSRC_DIR, csrc)
    monkeypatch.setattr(kbuild, "CSRC_DIR", csrc)
    return csrc


def test_library_path_changes_with_any_header(csrc_copy):
    before = {name: kbuild.library_path(name) for name in SOURCES}
    assert before == {name: kbuild.library_path(name) for name in SOURCES}  # pure
    assert len(set(before.values())) == len(SOURCES)
    header = csrc_copy / "hopper_wgmma.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    edited = {name: kbuild.library_path(name) for name in SOURCES}
    assert all(edited[name] != before[name] for name in SOURCES)
    (csrc_copy / "another.cuh").write_text("#pragma once\n")  # a new header counts too
    added = {name: kbuild.library_path(name) for name in SOURCES}
    assert all(added[name] != edited[name] for name in SOURCES)
    header.write_text(header.read_text().replace("\n// an edit\n", ""))
    (csrc_copy / "another.cuh").unlink()
    assert {name: kbuild.library_path(name) for name in SOURCES} == before


def test_library_path_changes_with_its_source_only(csrc_copy):
    before = {name: kbuild.library_path(name) for name in SOURCES}
    source = csrc_copy / "paged_attention.cu"
    source.write_text(source.read_text() + "\n// an edit\n")
    after = {name: kbuild.library_path(name) for name in SOURCES}
    assert after["paged_attention"] != before["paged_attention"]
    assert all(after[name] == before[name] for name in SOURCES if name != "paged_attention")


def test_nvcc_command_finds_the_headers(monkeypatch, tmp_path):
    monkeypatch.setattr(kbuild, "find_nvcc", lambda: "nvcc")
    cmd = kbuild.nvcc_command(tmp_path / "copy.cu", tmp_path / "libcopy.so")
    assert cmd[0] == "nvcc" and cmd[-1] == str(tmp_path / "copy.cu")
    assert cmd[cmd.index("-I") + 1] == str(kbuild.CSRC_DIR)
    assert cmd[cmd.index("-o") + 1] == str(tmp_path / "libcopy.so")
    assert "arch=compute_90a,code=sm_90a" in cmd


def test_attention_sources_share_one_copy_of_the_wgmma_helpers():
    header = (kbuild.CSRC_DIR / "hopper_wgmma.cuh").read_text()
    for name in ("paged_attention", "flash_attention"):
        src = (kbuild.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "hopper_wgmma.cuh"' in src
        for helper in ("desc_k_major", "desc_mn_major", "wgmma_m64n64k16_ss", "wgmma_pv", "pack_bf16"):
            assert re.search(rf"\b{helper}\(", header)
            assert not re.search(rf"(void|uint64_t|uint32_t) {helper}\(", src), (name, helper)
    for src in kbuild.CSRC_DIR.glob("*.cu"):  # every included header lies in csrc
        for included in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (kbuild.CSRC_DIR / included).is_file(), (src.name, included)


def test_quant_source_shares_the_wgmma_helpers():
    src = (kbuild.CSRC_DIR / "quant_matmul.cu").read_text()
    assert '#include "hopper_wgmma.cuh"' in src
    for helper in ("smem_u32", "cp_async16", "desc_k_major", "wgmma_fence", "wgmma_commit", "wgmma_wait0",
                   "fence_regs", "pack_bf16", "sw128_desc", "fence_acc"):
        assert not re.search(rf"(void|uint64_t|uint32_t) {helper}\(", src), helper
    assert "quant_matmul.cu" in (kbuild.CSRC_DIR / "hopper_wgmma.cuh").read_text()  # its note names who includes it


SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,source", [
    ("ablate_quant_prefill", "quant_matmul"), ("ablate_quant_decode", "quant_matmul"),
    ("ablate_paged_decode", "paged_attention"), ("ablate_paged_prefill", "paged_attention"),
])
def test_ablation_scripts_find_their_lines(name, source):
    src = (kbuild.CSRC_DIR / f"{source}.cu").read_text()
    variants = _script(name).ablated_sources(src)  # raises SystemExit when a line is missing
    assert variants["kernel"] == src
    assert all(text != src for variant, text in variants.items() if variant != "kernel")


def test_fault_scripts_find_their_lines():
    quant = (kbuild.CSRC_DIR / "quant_matmul.cu").read_text()
    for line, planted, _ in _script("plant_quant_faults").FAULTS.values():
        assert quant.count(line) == 1 and planted != line
    for name, line, planted, _ in _script("plant_attention_faults").FAULTS.values():
        assert (kbuild.CSRC_DIR / f"{name}.cu").read_text().count(line) == 1 and planted != line

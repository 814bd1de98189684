"""The kernel build's plumbing on the CPU, with a stand-in ``nvcc`` (a
script that records its arguments and writes its ``-o`` file): a source
of ``build.PARTS`` compiles as one object a part (``-DBUILD_PART=<i>``),
the parts started together and linked into its one library; any other
source builds whole; a library already built is not built again; a
failing part leaves no library and no object behind."""
import json
import sys

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import build  # noqa: E402

FAKE = """\
import json, os, sys
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps(args) + "\\n")
if os.environ.get("FAKE_NVCC_FAIL") and "-DBUILD_PART=1" in args:
    sys.exit(3)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
print("ptxas info    : Used 32 registers")
"""


def _fake_nvcc(tmp_path, monkeypatch, fail: bool = False):
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\n{FAKE}")
    script.chmod(0o755)
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    if fail:
        monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    monkeypatch.setattr(build, "nvcc", lambda: str(script))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    return log


def test_parts_compile_apart_and_link_into_one_library(tmp_path, monkeypatch):
    log = _fake_nvcc(tmp_path, monkeypatch)
    logs = build.build_all(["decode_attention", "attention_combine"])
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    parts = [c for c in calls if "-c" in c]
    assert sorted(a for c in parts for a in c if a.startswith("-DBUILD_")) \
        == ["-DBUILD_PART=0", "-DBUILD_PART=1"]
    assert all("-shared" not in c and c[-1].endswith("decode_attention.cu")
               for c in parts)
    links = [c for c in calls if not c[-1].endswith(".cu")]
    assert len(links) == 1 and "-shared" in links[0]
    assert sorted(a for a in links[0] if a.endswith(".o")) == sorted(
        c[c.index("-o") + 1] for c in parts)
    whole = [c for c in calls if c[-1].endswith("attention_combine.cu")]
    assert len(whole) == 1 and "-shared" in whole[0] and "-c" not in whole[0]
    assert sorted(p.name for p in (tmp_path / "libs").iterdir()) == sorted(
        build.lib_path(n).name for n in ("decode_attention",
                                         "attention_combine"))
    assert logs["decode_attention"].count("ptxas info") == 2
    assert build.build_all(["decode_attention"]) == {"decode_attention": ""}
    assert len(log.read_text().splitlines()) == len(calls)


def test_a_failing_part_leaves_nothing_behind(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, fail=True)
    with pytest.raises(RuntimeError,
                       match="nvcc failed for paged_decode_attention.cu"):
        build.build_all(["paged_decode_attention"])
    assert list((tmp_path / "libs").iterdir()) == []


def test_the_parts_name_their_library():
    """A library's name hashes its source, the headers, the flags and
    the number of parts it is built in."""
    assert build.PARTS == {"decode_attention": 2,
                           "paged_decode_attention": 2, "ssm_scan_bwd": 2,
                           "flash_attention": 2, "flash_attention_bwd": 2,
                           "paged_flash_attention": 3}
    names = {build.lib_path(n).name for n in build.sources()}
    assert len(names) == len(build.sources())

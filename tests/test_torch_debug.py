"""The port's witness debug tooling (`witness/debug.py`) against the JAX
package's: the kernel's in-memory tries decoded (`decode_trie_node`), the
decoder's tries in the same shape (`trie_shape`), their structural diff
(`trie_diff`), the error bundle a failed witness run writes
(`dump_error_artifacts`, named in a note on the exception) and the
command line's `trie-diff`. Same inputs, same outputs (tolerance 0); the
bundle's directory name carries the time, so only its files are
compared.
"""

import copy
import json
import os

import pytest

from zk_evm_tpu.tables.segments import Segment as JSegment
from zk_evm_tpu.witness import debug as jdebug
from zk_evm_tpu.witness.assembler import combined_kernel as jkernel
from zk_evm_tpu.witness.interpreter import run_generation as jrun
from zk_evm_tpu.witness.segments import (
    SegmentDataIterator as JSegmentDataIterator,
    run_segment_generation as jrun_segment)
from zk_evm_tpu.witness.testing_fixtures import FIXTURES as JFIXTURES
from zk_evm_tpu_torch.tables.segments import Segment
from zk_evm_tpu_torch.witness import debug, mpt_load
from zk_evm_tpu_torch.witness.interpreter import run_generation
from zk_evm_tpu_torch.witness.kernel import combined_kernel
from zk_evm_tpu_torch.witness.segments import (SegmentDataIterator,
                                               run_segment_generation)
from zk_evm_tpu_torch.witness.testing_fixtures import FIXTURES

# a cycle budget far below any block's: the witness run stops early
TINY_MAX_CYCLES = 3000


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def tries(request):
    """(port, JAX) of each fixture: the kernel's state trie after the
    witness run, as raw TrieData words with its root pointer, and the
    decoder's pre-state trie root."""
    name = request.param
    out = []
    for run, kernel, fixtures, seg in (
            (run_generation, combined_kernel, FIXTURES, Segment),
            (jrun, jkernel, JFIXTURES, JSegment)):
        inputs = fixtures[name]()
        interp = run(kernel(), inputs)
        out.append((list(interp.memory.preinit_view(seg.TrieData)),
                    interp.trie_root_ptrs["state"],
                    inputs.tries.state.root))
    return out


def test_decode_trie_node_equals_jax(tries):
    (data, root, _), (jdata, jroot, _) = tries
    assert (data, root) == (jdata, jroot)
    got = debug.decode_trie_node(data, root)
    assert got == jdebug.decode_trie_node(jdata, jroot)
    assert got["type"] == "branch"
    # a corrupt node type, a dangling pointer and a hash node
    bad = list(data)
    child = next(p for p in data[root + 1:root + 17] if p)
    bad[child] = 99
    assert debug.decode_trie_node(bad, root) == \
        jdebug.decode_trie_node(bad, root)
    assert {"type": "corrupt(99)", "ptr": child} in \
        debug.decode_trie_node(bad, root)["children"].values()
    assert debug.decode_trie_node(data, len(data)) == {"type": "empty"}
    hashed = data + [mpt_load.MPT_NODE_HASH, 0xABC]
    assert debug.decode_trie_node(hashed, len(data)) == \
        jdebug.decode_trie_node(hashed, len(data)) == \
        {"type": "hash", "digest": "0xabc"}


def test_trie_shape_and_diff_equal_jax(tries):
    (data, root, trie), (jdata, jroot, jtrie) = tries
    shape = debug.trie_shape(trie)
    assert shape == jdebug.trie_shape(jtrie)
    kernel_view = debug.decode_trie_node(data, root)
    diff = debug.trie_diff(kernel_view, shape)
    assert diff == jdebug.trie_diff(kernel_view, shape)
    assert debug.trie_diff(shape, shape) == []
    # a tampered copy: one leaf key, one child dropped, one type changed
    bad = copy.deepcopy(shape)
    kids = bad["children"]
    first, *rest = sorted(kids)
    leaf = kids[first] if kids[first]["type"] == "leaf" else next(
        c for c in kids[first]["children"].values() if c["type"] == "leaf")
    leaf["key"] = leaf["key"][:-1] + ("0" if leaf["key"][-1] != "0"
                                      else "1")
    del kids[rest[0]]
    kids["e"] = {"type": "hash", "digest": "0x00"}
    got = debug.trie_diff(shape, bad)
    assert got == jdebug.trie_diff(shape, bad)
    assert len(got) == 3
    assert debug.trie_diff(bad, {"type": "empty"}) == \
        jdebug.trie_diff(bad, {"type": "empty"}) == ["/: branch != empty"]


def bundle(note: str) -> dict:
    path = note.split("debug artifacts: ", 1)[1]
    return {f: json.load(open(os.path.join(path, f)))
            for f in sorted(os.listdir(path))}


def failed_run(run, kernel, fixtures, name, tmp_path, monkeypatch,
               segment=None):
    monkeypatch.setenv("ZK_EVM_TPU_DEBUG_DIR", str(tmp_path))
    inputs = fixtures[name]()
    with pytest.raises(RuntimeError, match="exceeded max_cycles") as e:
        if segment is None:
            run(kernel(), inputs, max_cycles=TINY_MAX_CYCLES)
        else:
            seg = next(segment(kernel(), inputs, None))
            run(kernel(), inputs, seg, max_cycles=TINY_MAX_CYCLES)
    (note,) = e.value.__notes__
    assert note.split(": ", 1)[1].startswith(str(tmp_path))
    return note.split(": ", 1)[0], bundle(note)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_error_bundle_equals_jax(name, tmp_path, monkeypatch):
    """A witness run stopped by a tiny max_cycles: both packages note
    the bundle on the exception and write the same state.json and
    state_trie_diff.json."""
    got = failed_run(run_generation, combined_kernel, FIXTURES, name,
                     tmp_path / "port", monkeypatch)
    want = failed_run(jrun, jkernel, JFIXTURES, name, tmp_path / "jax",
                      monkeypatch)
    assert got == want
    label, files = got
    assert label == "witness debug artifacts"
    assert sorted(files) == ["state.json", "state_trie_diff.json"]
    state = files["state.json"]
    assert state["error"] == "RuntimeError('interpreter exceeded "\
        "max_cycles')"
    assert state["clock"] >= TINY_MAX_CYCLES
    assert len(state["trace_tail"]) == 200


def test_segment_error_bundle_equals_jax(tmp_path, monkeypatch):
    """The tracing re-run of a segment, stopped by a tiny max_cycles,
    notes its bundle under the segment's index in both packages."""
    got = failed_run(run_segment_generation, combined_kernel, FIXTURES,
                     "add11", tmp_path / "port", monkeypatch,
                     segment=lambda k, i, log: iter(
                         SegmentDataIterator(k, i, log)))
    want = failed_run(jrun_segment, jkernel, JFIXTURES, "add11",
                      tmp_path / "jax", monkeypatch,
                      segment=lambda k, i, log: iter(
                          JSegmentDataIterator(k, i, log)))
    assert got == want
    assert got[0] == "segment 0 debug artifacts"


def test_error_bundle_default_directory(tmp_path, monkeypatch):
    """Without ZK_EVM_TPU_DEBUG_DIR the bundle goes under the temporary
    directory (TMPDIR)."""
    monkeypatch.delenv("ZK_EVM_TPU_DEBUG_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    with pytest.raises(RuntimeError) as e:
        run_generation(combined_kernel(), FIXTURES["add11"](),
                       max_cycles=TINY_MAX_CYCLES)
    path = e.value.__notes__[0].split(": ", 1)[1]
    assert os.path.dirname(path) == str(tmp_path / "zk_evm_tpu_debug")
    assert sorted(os.listdir(path)) == ["state.json",
                                        "state_trie_diff.json"]


def test_cli_trie_diff(tmp_path, capsys):
    """`trie-diff A B`: exit 0 and the JAX package's line on equal
    shapes, exit 1 and the diff lines otherwise."""
    from zk_evm_tpu.__main__ import main as jmain
    from zk_evm_tpu_torch.__main__ import main
    shape = debug.trie_shape(FIXTURES["add11"]().tries.state.root)
    bad = copy.deepcopy(shape)
    bad["children"].pop(sorted(bad["children"])[-1])
    paths = {}
    for name, obj in (("a", shape), ("b", copy.deepcopy(shape)),
                      ("bad", bad)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(obj))
    for other, rc in (("b", 0), ("bad", 1)):
        argv = ["trie-diff", str(paths["a"]), str(paths[other])]
        assert main(argv) == rc
        got = capsys.readouterr().out
        assert jmain(argv) == rc
        assert got == capsys.readouterr().out
        if rc:
            assert got.splitlines() == [
                f"/{sorted(shape['children'])[-1]}: present in kernel vs "
                f"decoder"]
        else:
            assert got == "tries are structurally identical\n"

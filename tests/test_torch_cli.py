"""The port's command line against the JAX package's: `decode` prints the
same JSON lines for the fixture witnesses, `prove --witness` and `verify`
refuse to run without a card, and (slow) `verify --device cpu` accepts the
JAX package's mainnet proof of block 1033, batch 0.
"""

import gzip
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from zk_evm_tpu_torch.witness.testing_fixtures import build_witness_chain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def witness_files(tmp_path_factory):
    """name -> a witness file: each chain as a list [A, B], and add11's
    block A alone as one object."""
    d = tmp_path_factory.mktemp("witness")
    out = {}
    for name in ("add11", "simple-transfer"):
        witnesses, _ = build_witness_chain(name)
        out[name] = d / f"{name}.json"
        out[name].write_text(json.dumps(witnesses))
        if name == "add11":
            out["add11-block-A"] = d / "add11-block-A.json"
            out["add11-block-A"].write_text(json.dumps(witnesses[0]))
    return out


def lines(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("batch_size", [None, 1])
@pytest.mark.parametrize("name", ["add11", "simple-transfer",
                                  "add11-block-A"])
def test_decode_prints_the_jax_line(witness_files, name, batch_size,
                                    capsys):
    from zk_evm_tpu.__main__ import main as jmain
    from zk_evm_tpu_torch.__main__ import main
    argv = ["decode", str(witness_files[name])]
    if batch_size is not None:
        argv += ["--batch-size", str(batch_size)]
    got = lines(main, argv, capsys)
    assert got == lines(jmain, argv, capsys)
    blocks = [json.loads(line) for line in got]
    assert [b["batches"] for b in blocks] == [2] * len(blocks)
    _, roots = build_witness_chain(name.removesuffix("-block-A"))
    assert [b["post_state_root"] for b in blocks] \
        == ["0x" + r.state_root.hex() for r in roots[:len(blocks)]]


def test_cli_prove_witness_refuses_without_card(witness_files):
    """`prove --witness` defaults to CUDA: with no card visible it raises
    rather than proving on the CPU (run with no card visible, so that it
    refuses on a card's host too)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "zk_evm_tpu_torch", "prove", "--witness",
         str(witness_files["add11"]), "-o", os.devnull],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("form", ["segments", "block-checkpoint"])
def test_cli_verify_refuses_without_card(tmp_path, monkeypatch, form):
    """`verify` of a segment list, and `verify --checkpoint`, default to
    CUDA: with no card they raise before reading the proof."""
    from zk_evm_tpu_torch.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "proof.zkproof"
    path.write_text("[]")
    argv = ["verify", str(path)] + (["--checkpoint"]
                                    if form == "block-checkpoint" else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_cli_prove_needs_one_source():
    from zk_evm_tpu_torch.__main__ import main
    with pytest.raises(SystemExit):
        main(["prove", "--fixture", "add11", "--witness", "w.json"])
    with pytest.raises(SystemExit):
        main(["prove"])


@pytest.mark.slow
def test_cli_verify_b1033_batch0_on_cpu(tmp_path, capsys):
    """The JAX package's standard-config proof of mainnet block 1033,
    batch 0 (two segment AllProofs), verified by the port's CLI on the
    CPU. About two minutes."""
    from zk_evm_tpu_torch.__main__ import main
    path = tmp_path / "b1033_batch0.zkproof"
    with gzip.open(os.path.join(REPO, "b1033_batch0.zkproof.gz")) as src, \
            open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    (line,) = lines(main, ["verify", str(path), "--device", "cpu"], capsys)
    assert json.loads(line) == {"ok": True, "proof": str(path),
                                "segments": 2}

"""The port's runtime configuration (`runtime_config.py`) and the command
line's global options against the JAX package's: defaults, the config
file, the ZK_* environment and the command line resolve in the same
order to the same values, and the same inputs are refused.

Two differences, recorded in ROADMAP.md (Queue 3): a `max_cpu_len_log`
of 0, which the config gives by default and documents as "no
segmentation", makes the JAX command line's segment iterator assert; the
port's command line resolves it to one unsegmented run. And the port
keeps only the settings a command reads: it has no `prove_config` or
`proof_dir`, and refuses a flavor other than eth_mainnet, which the JAX
config accepts and no JAX command proves.
"""

import dataclasses
import json

import pytest

from zk_evm_tpu import runtime_config as jrc
from zk_evm_tpu_torch import runtime_config as rc


# the JAX settings that no command of either package reads; the port
# does not carry them
UNREAD = ("prove_config", "proof_dir")


def both(**kw):
    """(port, JAX) RuntimeConfig of one load, as dicts; the JAX one
    without the settings the port does not carry."""
    want = dataclasses.asdict(jrc.load(**kw))
    return (dataclasses.asdict(rc.load(**kw)),
            {k: v for k, v in want.items() if k not in UNREAD})


def test_defaults():
    got, want = both(env={})
    assert got == want
    c = rc.load(env={})
    assert (c.flavor, c.max_cpu_len_log, c.batch_size, c.log_level) == \
        ("eth_mainnet", 0, 10, "warning")
    assert not any(hasattr(c, k) for k in UNREAD + ("stark_config",))


def test_file_then_env_then_cli(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"flavor": "eth_mainnet", "batch_size": 5}))
    got, want = both(config_path=str(p), env={"ZK_BATCH_SIZE": "7"})
    assert got == want
    assert got["batch_size"] == 7                 # env beats file
    got, want = both(config_path=str(p), env={"ZK_BATCH_SIZE": "7"},
                     cli_overrides={"batch_size": 9, "flavor": None})
    assert got == want
    assert got["batch_size"] == 9                 # CLI beats env
    assert got["flavor"] == "eth_mainnet"         # None leaves it unset
    env = {"ZK_CONFIG": str(p), "ZK_LOG": "debug",
           "ZK_MAX_CPU_LEN_LOG": "12"}
    got, want = both(env=env)
    assert got == want
    assert (got["log_level"], got["max_cpu_len_log"],
            got["batch_size"]) == ("debug", 12, 5)


def test_standard_config_and_validation():
    """The same values are refused by both packages; ZK_PROVE_CONFIG and
    ZK_PROOF_DIR, which no command reads, are not read by the port."""
    for env in ({"ZK_FLAVOR": "bogus"}, {"ZK_MAX_CPU_LEN_LOG": "3"},
                {"ZK_MAX_CPU_LEN_LOG": "25"}):
        with pytest.raises(AssertionError):
            rc.load(env=env)
        with pytest.raises(AssertionError):
            jrc.load(env=env)
    env = {"ZK_PROVE_CONFIG": "standard", "ZK_PROOF_DIR": "out"}
    assert rc.load(env=env) == rc.load(env={})
    assert (jrc.load(env=env).prove_config, jrc.load(env=env).proof_dir) \
        == ("standard", "out")


@pytest.mark.parametrize("flavor", ["cdk_erigon", "polygon_pos"])
def test_port_refuses_flavors_it_does_not_prove(flavor, tmp_path):
    """The JAX config accepts these flavors, and no JAX command proves
    them; the port refuses them from the environment, a config file and
    the command line, rather than prove an eth_mainnet block instead."""
    from zk_evm_tpu_torch.__main__ import main
    assert jrc.load(env={"ZK_FLAVOR": flavor}).flavor == flavor
    with pytest.raises(AssertionError, match="eth_mainnet only"):
        rc.load(env={"ZK_FLAVOR": flavor})
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"flavor": flavor}))
    with pytest.raises(AssertionError, match="eth_mainnet only"):
        rc.load(config_path=str(p), env={})
    with pytest.raises(SystemExit):
        main(["--flavor", flavor, "decode", "w.json"])


def test_config_file_with_unread_settings_refused(tmp_path):
    """A JAX config file naming `prove_config` or `proof_dir` is refused
    by the port as having unknown keys; the JAX package resolves it."""
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"prove_config": "standard", "proof_dir": "o"}))
    assert jrc.load(config_path=str(p), env={}).prove_config == "standard"
    with pytest.raises(AssertionError, match="unknown config keys: "
                       r"\['proof_dir', 'prove_config'\]"):
        rc.load(config_path=str(p), env={})


def test_unknown_file_keys_rejected(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"flavour": "typo"}))
    with pytest.raises(AssertionError, match="unknown config keys") as e:
        rc.load(config_path=str(p), env={})
    with pytest.raises(AssertionError) as je:
        jrc.load(config_path=str(p), env={})
    assert str(e.value) == str(je.value)


def test_cli_plumbs_config(tmp_path):
    """--flavor/--log-level parse and resolve without running a prove;
    an unknown command exits as the JAX command line does."""
    from zk_evm_tpu.__main__ import main as jmain
    from zk_evm_tpu_torch.__main__ import main
    for entry in (main, jmain):
        with pytest.raises(SystemExit):
            entry(["--flavor", "cdk_erigon", "badcmd"])
        with pytest.raises(SystemExit):
            entry(["--log-level", "loud", "decode", "w.json"])


def resolved(monkeypatch, argv, env=None):
    """The args the port's `prove` would run with, for `argv`."""
    from zk_evm_tpu_torch import __main__ as cli
    for var in rc.RuntimeConfig._ENV.values():
        monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv("ZK_CONFIG", raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(cli, "cmd_prove",
                        lambda args: seen.setdefault("args", args) and 0)
    monkeypatch.setattr(cli, "cmd_decode",
                        lambda args: seen.setdefault("args", args) and 0)
    cli.main(argv)
    return seen["args"]


def test_cli_backfills_batch_size_and_segments(monkeypatch, tmp_path):
    """Unset --batch-size and --max-cpu-len-log take the resolved config
    (the JAX command line's backfill, zk_evm_tpu/__main__.py:298-313)."""
    prove = ["prove", "--fixture", "add11"]
    args = resolved(monkeypatch, prove)
    assert (args.batch_size, args.max_cpu_len_log) == (10, None)
    assert not hasattr(args, "runtime_config")
    args = resolved(monkeypatch, prove + ["--max-cpu-len-log", "15",
                                          "--batch-size", "3"],
                    env={"ZK_MAX_CPU_LEN_LOG": "14", "ZK_BATCH_SIZE": "4"})
    assert (args.batch_size, args.max_cpu_len_log) == (3, 15)
    args = resolved(monkeypatch, prove,
                    env={"ZK_MAX_CPU_LEN_LOG": "14", "ZK_BATCH_SIZE": "4"})
    assert (args.batch_size, args.max_cpu_len_log) == (4, 14)
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"batch_size": 2}))
    args = resolved(monkeypatch, ["--config", str(p), "decode", "w.json"])
    assert args.batch_size == 2


def test_max_cpu_len_log_zero_means_no_segmentation(monkeypatch):
    """The finding: with the config's default `max_cpu_len_log` of 0 the
    JAX command line hands 0 to the segment iterator, whose cycle budget
    asserts (zk_evm_tpu/__main__.py:311-312, witness/segments.py:76-81);
    the port's command line resolves 0 to None, one unsegmented run.
    Both iterators keep the same budget for the values they are given."""
    from zk_evm_tpu.witness.assembler import combined_kernel as jkernel
    from zk_evm_tpu.witness.segments import (
        SegmentDataIterator as JSegmentDataIterator)
    from zk_evm_tpu.witness.testing_fixtures import FIXTURES as JFIXTURES
    from zk_evm_tpu_torch.witness.kernel import combined_kernel
    from zk_evm_tpu_torch.witness.segments import SegmentDataIterator
    from zk_evm_tpu_torch.witness.testing_fixtures import FIXTURES
    assert jrc.load(env={}).max_cpu_len_log == 0
    assert rc.load(env={}).max_cpu_len_log == 0
    jit = JSegmentDataIterator(jkernel(), JFIXTURES["add11"](), 0)
    with pytest.raises(AssertionError,
                       match="max_cpu_len_log too small for the epilogue"):
        jit._cycle_limit()
    args = resolved(monkeypatch, ["prove", "--fixture", "add11"])
    assert args.max_cpu_len_log is None
    it = SegmentDataIterator(combined_kernel(), FIXTURES["add11"](),
                             args.max_cpu_len_log)
    assert it._cycle_limit() is None
    assert len(list(it)) == 1
    for log in (0, 15):
        it = SegmentDataIterator(combined_kernel(), FIXTURES["add11"](),
                                 log)
        jit = JSegmentDataIterator(jkernel(), JFIXTURES["add11"](), log)
        if log:
            assert it._cycle_limit() == jit._cycle_limit() == (1 << 15) - 82
        else:
            with pytest.raises(AssertionError):
                it._cycle_limit()

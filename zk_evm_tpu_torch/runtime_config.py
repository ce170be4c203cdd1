"""Runtime configuration: env + file + CLI flags.

The reference's zero binaries are configured by clap flags and env vars
(zero/src/prover.rs CliProverConfig; RUST_LOG etc.). The port's twin: one
`RuntimeConfig` resolved in precedence order CLI > env > config file >
defaults, consumed by the CLI entry points.

Env vars (all optional):
    ZK_FLAVOR        eth_mainnet            (the only flavor the port's
                                             witness path proves)
    ZK_CONFIG        path to a JSON config file
    ZK_MAX_CPU_LEN_LOG  segment size 2^N    (zk-continuations)
    ZK_BATCH_SIZE    txns per batch (decoder)
    ZK_LOG           error|warn|info|debug  (metrics.setup_logging)
    ZK_WITNESS_DIR   the directory a worker's prove_block jobs may read
                     witness files from (default: its working directory)
    ZK_OUTPUT_DIR    the directory they may write proof files to
                     (default: its working directory)

The JAX package's config also resolves `prove_config` (ZK_PROVE_CONFIG)
and `proof_dir` (ZK_PROOF_DIR), which none of its commands reads, and
accepts the cdk_erigon and polygon_pos flavors, which its command line
does not prove. The port has neither setting, so a config file that names
them is refused as having unknown keys, and it refuses any flavor but
eth_mainnet rather than prove an eth_mainnet block in its place.
`witness_dir` and `output_dir` are the port's own: a worker refuses a job
that names a file outside them (`orchestration/queue.py`), which the JAX
package's worker does not.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields
from typing import ClassVar


@dataclass
class RuntimeConfig:
    flavor: str = "eth_mainnet"
    max_cpu_len_log: int = 0            # 0 = no segmentation
    batch_size: int = 10
    log_level: str = "warning"
    witness_dir: str = "."
    output_dir: str = "."

    _ENV: ClassVar[dict] = {
        "flavor": "ZK_FLAVOR",
        "max_cpu_len_log": "ZK_MAX_CPU_LEN_LOG",
        "batch_size": "ZK_BATCH_SIZE",
        "log_level": "ZK_LOG",
        "witness_dir": "ZK_WITNESS_DIR",
        "output_dir": "ZK_OUTPUT_DIR",
    }

    def validate(self) -> "RuntimeConfig":
        assert self.flavor == "eth_mainnet", \
            f"flavor {self.flavor!r}: the port proves eth_mainnet only"
        assert self.max_cpu_len_log == 0 or \
            8 <= self.max_cpu_len_log <= 24, self.max_cpu_len_log
        return self


def load(cli_overrides: dict | None = None,
         config_path: str | None = None,
         env: dict | None = None) -> RuntimeConfig:
    """Resolve CLI > env > file > defaults."""
    env = os.environ if env is None else env
    values: dict = {}
    path = config_path or env.get("ZK_CONFIG")
    if path:
        with open(path) as f:
            file_cfg = json.load(f)
        known = {f.name for f in fields(RuntimeConfig)
                 if not f.name.startswith("_")}
        unknown = set(file_cfg) - known
        assert not unknown, f"unknown config keys: {sorted(unknown)}"
        values.update(file_cfg)
    for name, var in RuntimeConfig._ENV.items():
        if var in env:
            values[name] = env[var]
    for k, v in (cli_overrides or {}).items():
        if v is not None:
            values[k] = v
    for int_key in ("max_cpu_len_log", "batch_size"):
        if int_key in values:
            values[int_key] = int(values[int_key])
    return RuntimeConfig(**values).validate()

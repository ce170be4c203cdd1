"""Smoke run of the PyTorch/CUDA port (zk_evm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py b1033-wrap     # path 12 with every chunk proved

Builds the four hand-written CUDA Poseidon kernels and the keccak256
rows kernel from zk_evm_tpu_torch/csrc/ (one nvcc per source, started
together), logs each kernel's registers and spills as ptxas reported
them, and holds each Poseidon kernel against its plain PyTorch version,
the python-int host twin, the python-int twin of the fast partial-round
form the kernels run (`hash/poseidon_fast.py`) and that of the planes
kernels' 32-bit arithmetic (`hash/goldilocks32.py`), on random states and
on states made of one boundary value in every lane. The sponges are held
at widths whose n_cols % 8 runs from 0 to 7, at row counts that are and
are not multiples of the planes sponge's tile, and, for the planes
sponge, on views it reads in place or through its aligned copy: an odd
row stride, a column-sliced view with a base off 16 bytes, one 16 bytes
on. Then it drives twelve paths of the port, each with the kernels'
launch counts set to 0 just before and read just after:

1. LogicStark: a 2^12-row proof on CUDA equals the CPU proof byte for
   byte; a 2^16-row, 523-column LogicStark is proved at the standard
   config (84 FRI queries, 16-bit proof of work) and verified.
2. The benchmark entry point, `zk_evm_tpu_torch.bench`: `main()` through
   the command line's `bench`, and `compare_poseidon_layouts()`, which run the dense and the planes
   Poseidon kernels; their JSON lines are printed.
3. The memory-continuation chain MemBefore -> Memory -> MemAfter under one
   transcript with logUp lookups and cross-table lookups: at Memory 2^10
   rows the CUDA `proof_to_json` equals the CPU one; at full width
   (786,432 preinitialized words, every table 2^20 rows) it is proved at
   the standard config and verified by the port's `verify_all`.
4. The Keccak commitment config (StarkConfig.hasher="keccak"): the
   keccak256 rows kernel (csrc/keccak.cu) against its plain version, the
   numpy batch hasher and native keccak256 at widths 3, 5, 17, 34 and 523
   (rows of one boundary value each among them), on 2^18 compress pairs
   and on a whole 64 x 2^16 tree against `build_tree_keccak`'s cap, with
   its times; "keccak_host" (the numpy tree) refuses leaves on the card;
   a 2^12-row LogicStark proved under "keccak" on CUDA equals
   the CPU proof; LogicStark 2^16 and the 2^20-row memory chain are
   proved under "keccak" at the standard config and verified, with the
   Keccak kernel launched and the Poseidon sponge not.
5. The cdk_erigon table set: `build_cdk_poseidon_scenario`'s ten-table
   AllStark (the Poseidon coprocessor driven by cdk CPU rows, its three
   CTLs and 56 byte reads) proved on the card at the test config equals
   the CPU proof, and its sha256 the JAX package's; the scenario with a
   7-block POSEIDON_GENERAL (an 8-row Poseidon table, the fewest the
   standard config's height-4 cap takes) is proved on the card at the
   standard config and verified; a wrong memory byte and a wrong digest
   are rejected.
6. An Ethereum block, through the port's command line
   (`zk_evm_tpu_torch.__main__.main`, in this process): `prove --fixture
   simple-transfer --max-cpu-len-log 15` at the standard config runs the
   witness generation (the native VM core, built from native/ with g++),
   proves the two segments on the card, chains MemAfter -> MemBefore and
   aggregates the block on the host; `verify` accepts the block proof and
   rejects it once one public value of the first segment changes (the
   two `verify` runs in processes of their own, at once). add11, a
   contract call, is proved in path 7. Then one segment of
   simple-transfer at the test config is proved on the card, and the
   sha256 of its `proof_to_json` must equal the JAX package's.
7. Blocks from a witness, through the command line: a two-block witness
   list written by `witness.testing_fixtures.build_witness_chain` (add11,
   anchored at its checkpoint, and its txn-less child with one
   withdrawal) is decoded (`decode`: the roots equal the fixture's), then
   proved by `prove --witness` at the standard config as 2 + 2 batches
   (the block decoder's masked tries, dummy batches and the withdrawal)
   with the chain checked (A's checkpoint anchor, B's parent link).
   `verify --checkpoint` accepts A and `verify` accepts B, five `verify`
   processes run together: B under `--checkpoint` and A with one public
   value changed exit 1, and the JAX package's standard-config proof of
   mainnet block 1033, batch 0 (two segments, `b1033_batch0.zkproof.gz`)
   is accepted.
8. The leader/worker service: `python3 -m zk_evm_tpu_torch leader` runs
   in a process of its own; four requests are POSTed to it: a
   prove_block job of the simple-transfer fixture, an echo, a job of an
   unknown kind, and a malformed body (refused with 400). The worker,
   `main(["worker", ...])` in this process, claims the three jobs from
   the queue directory and proves the block on the card (witness run,
   nine tables at the standard config, the host verifier's self-check,
   the proof file). A client thread polls `GET /jobs/<id>`: the proof is
   done, the echo echoes, the unknown kind fails, an unknown id gets 404
   and the leader's /metrics counts three jobs; the proof is verified by
   `verify` in a process of its own after the worker has exited and the
   checks have passed, and waited for before path 9 begins, so that no
   timed work overlaps it. The proof file's sha256 must equal the JAX
   package's worker's. The kernels line reports the dense pair's
   launches on this path, the permute's and the sponge's.
9. Recursion: the verifier VM (Rvm, its RAM table and the Poseidon table
   under one transcript, the Rvm's program in a preprocessed oracle).
   First a 16-row Fibonacci proof is verified in a tape
   (`verify_stark_tape`) and the tape proved by `prove_system` on the
   card: its `proof_to_json` sha256 equals the JAX package's, which
   tier-1 holds the port's CPU proof to. Then simple-transfer's segment chain at the test config
   (max_cpu_len_log 15: two segments, the nine tables at their real
   widths) is proved on the card, verified by the host, and the whole
   chain verified in one NativeTape (`wrap_segment_chain`, its statement
   hashed into 4 public inputs by `sponge_hash`; the fixture's statement
   is not anchored at its checkpoint, so `wrap_block` does not apply).
   The sha256 of the tape's Rvm and RAM traces must equal the JAX
   package's. The tape is proved at the standard config, in one proof
   when its Rvm has at most 2^21 rows, else in chunks
   (`prove_chunked`), and verified; a wrap proof with one FRI opening
   changed is rejected, and a child with one public value changed fails
   while its tape is built. Then the recursion ladder's top rungs: add11's
   block (block A of path 7's witness list) is decoded and its two
   batches proved on the card at the test config in segments of at most
   2^15 CPU rows (two segments, then one), aggregated on the host and
   checked as a checkpoint block; the whole block is verified in one
   NativeTape (`wrap_block`: each batch's segment chain, the batches
   chained, the block-initial checks and both consolidated hashes in the
   tape; `bind_block_publics` makes its 39 cells the public inputs),
   whose Rvm and RAM traces hash to the JAX package's, and proved at the
   standard config as one proof; `verify_block_wrap_chain` accepts it
   anchored at add11's checkpoint root, its FinalPublicValues and the
   other public inputs equal to `aggregate_block`'s statement, and
   rejects it with one FRI opening changed and against a wrong
   checkpoint root; a child with block_gas_used + 1 fails while its tape
   is built. Last, `two_to_one_tape` verifies that block wrap and the
   chain wrap above, two standard-config proofs, in one tape whose 4
   public inputs are `hash_no_pad` of both proofs' public inputs; it is
   proved at the standard config (in chunks past 2^21 ops) and verified,
   and a changed FRI opening in the outer proof or in one child is
   rejected.
10. One proof over several devices (`parallel.Mesh`, an ordered list of
   devices; on a host with one card every entry names cuda:0, so the
   splits, all-to-alls and gathers run, and no copy crosses cards):
   `sharded_commit_cap` at 64 x 2^16 over meshes of 1, 2 and 4 entries
   (and of every card, on a host with more than one) equals
   `commit_cap`'s cap, each entry launching one sponge and its
   subtree's permutes (counted exactly), timed beside `commit_cap`; a
   Keccak tree of 523 x 2^17 leaves over two entries equals the
   single-device tree; path 3's 2^20-row chain is proved again with its
   three trace commitments on three CUDA streams at once
   (`prove_all(parallel_commits=True)`, launching exactly what path 3
   launched), and over meshes of two and four entries (and of every
   card, on a host with more than one), each proof path 3's byte for
   byte. Over a mesh the stages between the commitments run on its row
   blocks, each block on a CUDA stream of its own: the
   block counts (`parallel.blocks.BLOCK_RUNS`, which the CPU tests read
   too) must show aux, the quotient, FRI's G and its first fold run k
   times a table on blocks of n/k or m/k entries; each run's aux,
   quotient, openings and FRI seconds are logged beside path 3's, with
   its launches and peak; `entry()` runs on the card (its cap is the JAX package's)
   and `dryrun_multichip(2)` passes over two cards, or, on a host with
   one, over a mesh that names cuda:0 twice; the native RPC
   fetcher, through `HttpTransport` against a JSON-RPC node on
   127.0.0.1 serving a toy block, returns the JAX package's object, whose
   decoded roots are the node's. The kernels line reports path 10's
   launches of each kernel as `mesh_launches`.
11. Programs assembled by the port's kernel-asm toolchain
   (`witness/asm_parser.py`, `stack_search.py`, `optimizer.py`,
   `assembler.py`), read from tests/data/asm_programs.json: the six
   snippet programs of tests/test_cpu.py and a loop (a macro with an
   argument, an @constant, a %stack directive, a local label and JUMPI;
   optimize=True) whose 62,412 steps fill a CPU table of 85 x 2^16 rows.
   Each code hash must equal the JAX assembler's pin; each program is
   interpreted to an empty stack at 0xdeadbeef and its CPU rows built.
   test_cpu.py's SRC is proved on the card at tests/test_stark.py's
   test config and its `proof_to_json` sha256 must equal the JAX
   package's; the loop's table is proved at the standard config,
   verified by the port's verifier, and rejected with one FRI opening
   changed. The loop kernel goes through the kernel cache
   (`orchestration/persistence.py`: `save_kernel`, `load_kernel`) and
   `run_kernel` of its routine returns the pinned sum; `python -m
   zk_evm_tpu_torch lsp`, in a process of its own, answers a framed
   session (initialize, semanticTokens/full, definition, hover,
   shutdown) with the pinned replies.
12. A real mainnet batch wrapped at the production config: the JAX
   package's standard-config proof of mainnet block 1033, batch 0 (two
   segments, the nine tables at 84 FRI queries and 16-bit proof of work,
   `b1033_batch0.zkproof.gz`) is verified in one NativeTape
   (`wrap_segment_chain`, the kernel's memory cap committed on the card,
   its statement hashed into 4 public inputs equal to the host
   `hash_no_pad` of segment 0's); the tape's 22 chunks of 2^20 ops are
   split one at a time and hashed (their Rvm then RAM traces, equal to
   the JAX package's) on a thread, their boundary maps chained, while
   chunks 0, 1 and the last are proved at the standard config and
   verified (`verify_chunk`), chunk 0's MemAfter cap equal to chunk 1's
   MemBefore cap. Proving three chunks of 22 is a cut in depth:
   `python3 chip_smoke.py b1033-wrap` proves and verifies all 22
   (`prove_chunked`, `verify_chunked`) and is not part of this run. A
   chunk proof with a changed FRI opening is rejected, and children with
   block_gas_used + 1 or a changed proof-of-work witness fail while their
   tapes are built.

The CPU proofs that paths 1, 3, 4 and 5 are held to (LogicStark 2^12
under each hasher, the 2^10 memory chain, the cdk scenario) are made in
one process of their own, at the lowest priority with
CPU_REFERENCE_THREADS torch threads, started before the kernels are
built. The kernels' checks and CUDA-event timings and the comparisons
with those CPU proofs run while it works; the timed paths (commit_cap,
LogicStark 2^16, the 2^20 chains, then paths 6-12) run after it has
ended, with nothing of this script beside them. A closing line gives
each phase's wall seconds.

Field arithmetic is exact, so every comparison is bit-for-bit equality:
the tolerance is 0. Every phase raises on failure. Needs one CUDA device;
without one it exits non-zero and prints no result.

The last three lines of standard output are the kernels' JSON record, the
card's `nvidia-smi` name and power limit, and the result JSON.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gzip
import hashlib
import importlib.util
import io
import json
import multiprocessing
import os
import queue
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from zk_evm_tpu_torch import __main__ as cli
from zk_evm_tpu_torch import bench, cuda_build, metrics, native, poseidon_ab
from zk_evm_tpu_torch.bench import cuda_ms, random_gf
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.field import GF, host
from zk_evm_tpu_torch.hash import (goldilocks32, host_poseidon,
                                   keccak_device, keccak_np, poseidon,
                                   poseidon_dense, poseidon_fast,
                                   poseidon_pallas)
from zk_evm_tpu_torch.merkle import build_commitment_tree, keccak_host
from zk_evm_tpu_torch.merkle.keccak_tree import (_digest_reduce,
                                                 build_tree_keccak)
from zk_evm_tpu_torch.orchestration.aggregation import (
    FinalPublicValues, aggregate_block, check_checkpoint_block,
    consolidate_hashes, prove_block_batches,
    rewrite_checkpoint_consolidation, verify_block_chain)
from zk_evm_tpu_torch.orchestration import persistence
from zk_evm_tpu_torch.orchestration.block import prove_block, verify_block
from zk_evm_tpu_torch.recursion import aggregate as agg
from zk_evm_tpu_torch.recursion import vm
from zk_evm_tpu_torch.recursion.continuation import (
    AFTER_T, BEFORE_T, iter_split_tape, prove_chunk, prove_chunked,
    verify_chunk, verify_chunked)
from zk_evm_tpu_torch.recursion.system import (RVM, prove_system,
                                               verify_system)
from zk_evm_tpu_torch.recursion.tape_lib import sponge_hash
from zk_evm_tpu_torch.recursion.verify_tape import verify_stark_tape
from zk_evm_tpu_torch.decoder import entrypoint, parse_block_prover_input
from zk_evm_tpu_torch.entry import dryrun_multichip, entry
from zk_evm_tpu_torch.parallel import (Mesh, block_runs, commit_cap,
                                       make_mesh, reset_block_runs,
                                       sharded_commit_cap)
from zk_evm_tpu_torch.rpc import CachedProvider, HttpTransport
from zk_evm_tpu_torch.rpc.fetch import native_block_prover_input
from zk_evm_tpu_torch.rpc.loopback import serve_loopback, toy_native_block
from zk_evm_tpu_torch.stark import (FriConfig, PolynomialBatch, Stark,
                                    StarkConfig, prove_all, prove_stark,
                                    verify_all, verify_stark)
from zk_evm_tpu_torch.stark.public_values import (h256_limbs as pvm_h256,
                                                  public_values_from_dict)
from zk_evm_tpu_torch.stark.serialization import (all_proof_from_dict,
                                                  block_proof_from_json,
                                                  proof_to_json)
from zk_evm_tpu_torch.tables import all_stark, cpu, cpu_columns as cc, \
    logic, memory
from zk_evm_tpu_torch.tables.memory_chain import (chain_traces,
                                                  preinitialized_words)
from zk_evm_tpu_torch.tables.scenarios import build_cdk_poseidon_scenario
from zk_evm_tpu_torch.tables.segments import Segment
from zk_evm_tpu_torch.timing import TimingTree, timed
from zk_evm_tpu_torch.witness import asm_parser, assembler, native_vm
from zk_evm_tpu_torch.witness.interpreter import Interpreter, run_kernel
from zk_evm_tpu_torch.witness.kernel import combined_kernel
from zk_evm_tpu_torch.witness.segments import generate_segment_tables
from zk_evm_tpu_torch.witness.testing_fixtures import (
    FIXTURES, build_witness_chain)

P = host.P
SEED = 0
# shapes of each phase (see the module docstring)
PERMUTE_BATCHES = (1, 1000, 1 << 18)        # 2^18: the PoW grind batch
SPONGE_COLS = (5, 6, 8, 13, 17, 32, 64, 523)
SPONGE_ROWS = (1, 1000, 4096)
# every n_cols % 8 from 1 to 7 beside SPONGE_COLS' 0, 1, 3, 5 and 6, on
# row counts that are not multiples of the planes sponge's 128-row tile:
# 1000 is read in place, 1001 (odd) through the aligned copy
RAGGED_COLS = (9, 10, 11, 12, 14, 15)
RAGGED_ROWS = (1000, 1001)
# views (ld, first column, n_rows) of a (VIEW_COLS, ld) matrix; the
# row stride is odd, or the base is 8 bytes off 16, or 16 bytes on
VIEW_COLS = 19
VIEW_SLICES = ((2001, 3, 997), (2000, 1, 999), (2000, 2, 1000))
COMMIT_POLYS = 64
COMMIT_CHECK_LOG_ROWS = 12
COMMIT_LOG_ROWS = 15                        # the commit-throughput shape
LOGIC_CHECK_LOG_ROWS = 12
LOGIC_LOG_ROWS = 16
CHAIN_CHECK_WORDS = 700                     # Memory 2^10 rows
CHAIN_WORDS = 3 << 18                       # every chain table 2^20 rows
CHAIN_LOG_ROWS = 20
CPU_REFERENCE_THREADS = 3                   # the CPU proofs' torch threads
# the block phase: proofs go under build/ at the root of the checkout
REPO = Path(__file__).resolve().parent
BLOCK_DIR = REPO / "build" / "smoke"
BLOCK_SEGMENT_LOG = 15                      # simple-transfer: 2 segments
KECCAK_COLUMNS = 2431                       # the widest leaf of the block
KECCAK_LOG_ROWS = 14                        # Keccak's minimum degree
# sha256 of the JAX package's proof_to_json(prove_block(...)) of the
# one-segment simple-transfer block (max_cpu_len_log=16, default table
# sizes) at StarkConfig.test_config(), made on the CPU;
# tests/test_torch_block.py holds the same constant
SIMPLE_TRANSFER_TEST_CONFIG_SHA256 = (
    "3902cdd9bd01926e9f362b7c14ea25972b7c1720ad086fc708f06891a3743470")
# the witness phase: add11 and its txn-less child, two batches each
WITNESS_FIXTURE = "add11"
WITNESS_BATCHES = [2, 2]
B1033_PROOF = REPO / "b1033_batch0.zkproof.gz"
# the service phase: a leader in a process of its own, the worker here
SERVICE_DIR = BLOCK_DIR / "service"
SERVICE_JOBS = 3                            # (a), (c), (d); (e) is refused
SERVICE_IDLE_S = 60                         # the worker's idle timeout
# sha256 of the proof file the JAX package's worker writes for
# {"kind": "prove_block", "fixture": "simple-transfer"} (the unsegmented
# block, default table sizes, StarkConfig()), made on the CPU;
# tests/test_torch_service.py holds the same constant
PROVE_BLOCK_SIMPLE_TRANSFER_SHA256 = (
    "ecc259fe9b373d56dc13c5d3fae1ae0890f1c10a98d7e5acc1238baa7edc9192")
# path 11: programs assembled by the port, their code hashes pinned from
# the JAX assembler (tests/test_torch_assembler.py holds both assemblers to
# them), the pinned sha256 of the JAX package's test-config CPU-table
# proof of test_cpu.py's SRC, and the language server's pinned replies
ASM_PROGRAMS = REPO / "tests" / "data" / "asm_programs.json"
ASM_TEST_CFG_KW = dict(rate_bits=1, cap_height=2, proof_of_work_bits=0,
                       num_query_rounds=2, arity_bits=2, final_poly_bits=2)
HALT = 0xDEADBEEF
# the recursion phase
WRAP_SEGMENT_LOG = 15                       # simple-transfer: 2 segments
WRAP_ONE_PROOF_LOG = 21                     # larger Rvm traces are chunked
WRAP_CHUNK_LOG = 20                         # prove_chunked's rows_log
FIB_ROWS = 16
FIB_CHILD_KW = dict(rate_bits=1, cap_height=1, proof_of_work_bits=0,
                    num_query_rounds=2, arity_bits=2, final_poly_bits=2)
FIB_OUTER_KW = dict(rate_bits=1, cap_height=2, proof_of_work_bits=0,
                    num_query_rounds=1, arity_bits=2, final_poly_bits=2)
# sha256 of the JAX package's proof_to_json(prove_system(...)) of the
# 16-row Fibonacci wrap at FIB_CHILD_KW / FIB_OUTER_KW, made on the CPU;
# tests/test_torch_recursion.py holds the same constant
FIB_WRAP_SHA256 = (
    "860392d5d51b68ac4d272c054a695026546397c78a3de82d1ca71ca6aa769b7e")
# sha256 over the Rvm trace's then the RAM trace's bytes of the chain
# wrap's tape, equal between the packages (the `slow` test of
# tests/test_torch_recursion.py)
WRAP_TAPE_SHA256 = (
    "1db1c79025b9fed5790ec18f819019ba7c0c62311eda6de3f253622b587b43b6")
# add11's block wrap: its batches at the test config in segments of at
# most 2^15 CPU rows (two segments, then one), wrapped by `wrap_block`
BLOCK_WRAP_SEGMENT_LOG = 15
BLOCK_WRAP_SEGMENTS = [2, 1]
# sha256 over the Rvm trace's then the RAM trace's bytes of add11's
# block-wrap tape, equal between the packages (the `slow` test of
# tests/test_torch_block_wrap.py)
BLOCK_WRAP_TAPE_SHA256 = (
    "71f0801850c5e8868925151f03c78b6dbc80f0d88a338264c8895bbf3122e860")
# path 12: the two standard-config segments of B1033_PROOF (mainnet block
# 1033, batch 0) verified in one `wrap_segment_chain` tape, split into
# chunks of 2^WRAP_CHUNK_LOG ops; the run proves B1033_PROVED_CHUNKS of
# them, a cut in depth (`python3 chip_smoke.py b1033-wrap` proves all)
B1033_BLOCK = 1033
B1033_WRAP_OPS = 22_343_757
B1033_WRAP_CHUNKS = 22
B1033_PROVED_CHUNKS = (0, 1, B1033_WRAP_CHUNKS - 1)
# sha256 over every chunk's Rvm trace's then RAM trace's bytes, in order
# (`chunks_sha256`), equal between the packages (the `slow` test of
# tests/test_torch_b1033_wrap.py)
B1033_WRAP_TAPE_SHA256 = (
    "423a2481c0168f4e077429cb3f3f8477b45bd3fb9452ae21ce49b6267b284e46")
# leaf shapes (n_cols, n_rows) of the main paths: the commit benchmark's
# 2^16-row LDE, the Logic trace's and the Memory trace's LDEs, and the
# planes sponge's shape in compare_poseidon_layouts
LEAF_SHAPES = ((COMMIT_POLYS, 2 << COMMIT_LOG_ROWS),
               (logic.NUM_COLUMNS, 2 << LOGIC_LOG_ROWS),
               (memory.NUM_COLUMNS, 2 << CHAIN_LOG_ROWS),
               (KECCAK_COLUMNS, 2 << KECCAK_LOG_ROWS),
               (64, 1 << 14))
BOUNDARY = (0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63)
# the Keccak phases: the kernel at these widths (Logic's leaves the widest)
# and as a compress level; then LogicStark and the memory chain proved
# under hasher="keccak"
KECCAK_WIDTHS = (3, 5, 17, 34, logic.NUM_COLUMNS)
KECCAK_CHECK_ROWS = 4096
KECCAK_PAIRS_LOG = 18
KECCAK_TREE_SHAPE = (COMMIT_POLYS, 1 << 16)  # (columns, leaves)
KECCAK_BOUNDARY = BOUNDARY + ((1 << 64) - 1,)
# the cdk_erigon scenario (tables/scenarios.py) at tests/test_cdk_flavor.py's
# config, and the sha256 of the JAX package's proof_to_json of it, made on
# the CPU; tests/test_torch_cdk.py holds the same constant
CDK_CFG_KW = dict(rate_bits=1, cap_height=2, proof_of_work_bits=0,
                  num_query_rounds=1, arity_bits=2, final_poly_bits=2)
CDK_SCENARIO_SHA256 = (
    "10d286ea5b1baf5a5dbd237ec15b0bfe1fc1a02007221a8a1d764ecef4301260")
# path 10, one proof over several devices: meshes that name cuda:0 1, 2
# and 4 times (and every card, on a host with more than one)
MESH_SIZES = (1, 2, 4)
MESH_COMMIT_SHAPE = (COMMIT_POLYS, 1 << 16)      # (polys, rows)
MESH_CAP_HEIGHT = 4
MESH_KECCAK_SHAPE = (logic.NUM_COLUMNS, 1 << 17)  # (columns, leaves)
MESH_CHAIN_SIZES = (2, 4)       # entries of cuda:0 the 2^20 chain runs over
# the timed phases of a table proof between its commitments, by the name
# `prove_stark` times them under
STAGES = {"aux": "generate aux columns", "quotient": "evaluate quotient",
          "openings": "openings", "FRI": "FRI"}
# sha256 over the little-endian bytes of the cap the JAX package's
# `__graft_entry__.entry()` computes; tests/test_torch_parallel.py holds
# the same constant
ENTRY_CAP_SHA256 = (
    "b0f3393b02e6e4420824c4e65c743ba068d2ec332c296abb4cac9e8e077612f8")
# sha256 of json.dumps(obj, sort_keys=True) of the JAX package's
# native_block_prover_input of the toy block (rpc/loopback.py, the case of
# tests/test_rpc.py); tests/test_torch_rpc.py holds the same constant
NATIVE_TOY_SHA256 = (
    "a65989905ba91c079aee142de6d42c847b8f0980596f1403c736a72fdbfa4b71")
KERNELS = {
    # name: (source, replaced TPU kernel, wrapper, launch counts, key)
    "poseidon_permute": ("zk_evm_tpu_torch/csrc/poseidon.cu",
                         "zk_evm_tpu/hash/poseidon_dense.py:143",
                         poseidon_dense.permute_dense,
                         poseidon_dense.LAUNCHES, "permute"),
    "poseidon_sponge": ("zk_evm_tpu_torch/csrc/poseidon.cu",
                        "zk_evm_tpu/hash/poseidon_dense.py:203",
                        poseidon_dense.sponge_dense,
                        poseidon_dense.LAUNCHES, "sponge"),
    "poseidon_pallas_permute": ("zk_evm_tpu_torch/csrc/poseidon_pallas.cu",
                                "zk_evm_tpu/hash/poseidon_pallas.py:182",
                                poseidon_pallas.permute_pallas,
                                poseidon_pallas.LAUNCHES, "permute"),
    "poseidon_pallas_sponge": ("zk_evm_tpu_torch/csrc/poseidon_pallas.cu",
                               "zk_evm_tpu/hash/poseidon_pallas.py:250",
                               poseidon_pallas.sponge_pallas,
                               poseidon_pallas.LAUNCHES, "sponge"),
    # plain XLA in the JAX package (`_keccak_rows` under jax.jit), not
    # Pallas: it is written for the card all the same
    "keccak_rows": ("zk_evm_tpu_torch/csrc/keccak.cu",
                    "zk_evm_tpu/hash/keccak_device.py:88",
                    keccak_device.keccak_rows, keccak_device.LAUNCHES,
                    "rows"),
}
PERMUTES = ("poseidon_permute", "poseidon_pallas_permute")
SPONGES = ("poseidon_sponge", "poseidon_pallas_sponge")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_abs_err(got: GF, want: GF) -> int:
    """Largest |got - want| over the elements, as exact integers."""
    g = got.to_u64()
    w = want.to_u64()
    if g.shape != w.shape:
        raise AssertionError(f"shape {g.shape} != {w.shape}")
    bad = np.nonzero(g != w)
    if not len(bad[0]):
        return 0
    return max(abs(int(a) - int(b)) for a, b in zip(g[bad], w[bad]))


def phase_environment() -> str:
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda "
                         "is_available() is false); nothing was run")
    smi = nvidia_smi()
    log(f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton not installed")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"jax importable: {importlib.util.find_spec('jax') is not None}")
    return smi


def sm_clock_mhz() -> float:
    """The SM clock `nvidia-smi` reports as the card's maximum."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def phase_build() -> None:
    names = ("poseidon", "poseidon_pallas", "keccak")
    how = {n: "reused" if cuda_build.library_path(n).exists()
           else "built with nvcc" for n in names}
    t0 = time.perf_counter()
    cuda_build.build_all(names)
    for n in names:
        cuda_build.load(n)
    log(f"build: {', '.join(f'csrc/{n}.cu {how[n]}' for n in names)}; "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    for n in names:
        resources = cuda_build.kernel_resources(cuda_build.ptxas_report(n))
        for mangled, res in resources.items():
            kernel = poseidon_ab.kernel_of(mangled) or next(
                (k for k in KERNELS if f"{k}_kernel" in mangled), mangled)
            log(f"ptxas {kernel}: "
                f"{res['registers']} registers, spill stores "
                f"{res['spill_stores']} bytes, spill loads "
                f"{res['spill_loads']} bytes")


def zero_counts() -> None:
    for _, _, _, counts, key in KERNELS.values():
        counts[key] = 0


def read_counts() -> dict:
    return {name: counts[key]
            for name, (_, _, _, counts, key) in KERNELS.items()}


def phase_permute(rng, dev) -> dict:
    """The permute kernels against the plain version on every state, and
    against the host twin and the fast-form twin on the first rows: at
    B = 1 the state is random; at larger B the first rows are the six
    states with one boundary value in every lane, then states mixed from
    boundary values."""
    err = dict.fromkeys(PERMUTES, 0)
    uniform = np.repeat(np.array(BOUNDARY, dtype=np.uint64)[:, None], 12,
                        axis=1)
    for batch in PERMUTE_BATCHES:
        states = rng.integers(0, P, size=(batch, 12), dtype=np.uint64)
        n_b = min(batch, 64)
        states[:n_b] = np.array(BOUNDARY, dtype=np.uint64)[
            rng.integers(0, len(BOUNDARY), size=(n_b, 12))]
        if batch > len(BOUNDARY):
            states[:len(BOUNDARY)] = uniform
        x = GF.from_u64(states, dev)
        want = poseidon.permute_plain(x)
        n_twins = min(batch, len(BOUNDARY) + 4)
        twins = []
        for r in range(n_twins):
            row = [int(v) for v in states[r]]
            twin = host_poseidon.permute_py(row)
            if poseidon_fast.permute_fast(row) != twin:
                raise AssertionError(f"fast-form twin != host twin, row {r}")
            if goldilocks32.permute_gl32(row) != twin:
                raise AssertionError(f"32-bit twin != host twin, row {r}")
            twins.append(twin)
        for name in PERMUTES:
            got = KERNELS[name][2](x)
            err[name] = max(err[name], max_abs_err(got, want))
            if err[name]:
                raise AssertionError(f"{name} kernel != plain at B={batch}")
            out = got.to_u64()
            for r, twin in enumerate(twins):
                if [int(v) for v in out[r]] != twin:
                    raise AssertionError(f"{name} row {r} != host twin")
    log(f"permute: dense and planes kernels == plain == host twin == "
        f"fast-form twin == 32-bit twin (exact) at B = {PERMUTE_BATCHES}, "
        f"boundary values {BOUNDARY} in every lane")
    return err


def check_sponges(err: dict, mt: GF, names, what: str) -> None:
    """The sponge kernels `names` on the (n_cols, n_rows) matrix mt against
    the plain version on every leaf and the host twin on leaves 0 and -1
    (exact); the largest error is kept in err."""
    m = mt.to_u64()
    want = poseidon.hash_rows_plain(mt.T)
    twins = [host_poseidon.hash_or_noop([int(v) for v in m[:, r]])
             for r in (0, -1)]
    for name in names:
        got = KERNELS[name][2](mt)
        err[name] = max(err[name], max_abs_err(got, want))
        if err[name]:
            raise AssertionError(f"{name} kernel != plain at {what}")
        out = got.to_u64()
        if [[int(v) for v in out[r]] for r in (0, -1)] != twins:
            raise AssertionError(f"{name} at {what} != host twin")


def phase_sponge(rng, dev) -> dict:
    err = dict.fromkeys(SPONGES, 0)
    shapes = [(c, r) for c in SPONGE_COLS for r in SPONGE_ROWS] \
        + [(c, r) for c in RAGGED_COLS for r in RAGGED_ROWS]
    for n_cols, n_rows in shapes:
        m = rng.integers(0, P, size=(n_cols, n_rows), dtype=np.uint64)
        k = min(n_cols, len(BOUNDARY))
        m[:k, 0] = BOUNDARY[:k]                 # leaf 0: boundary values
        check_sponges(err, GF.from_u64(m, dev), SPONGES,
                      f"{n_cols}x{n_rows}")
    for ld, first, n_rows in VIEW_SLICES:
        base = GF.from_u64(rng.integers(0, P, size=(VIEW_COLS, ld),
                                        dtype=np.uint64), dev)
        view = GF(base.v[:, first:first + n_rows])
        copied = poseidon_pallas.needs_aligned_copy(view.v)
        if copied != (ld % 2 == 1 or first % 2 == 1):
            raise AssertionError(f"aligned copy {copied} for ld {ld}, "
                                 f"first column {first}")
        check_sponges(err, view, ("poseidon_pallas_sponge",),
                      f"a {VIEW_COLS}x{n_rows} view of ld {ld} from column "
                      f"{first}")
    log(f"sponge: dense and planes kernels == plain == host twin (exact) at "
        f"n_cols {SPONGE_COLS} x n_rows {SPONGE_ROWS}, n_cols {RAGGED_COLS} "
        f"x n_rows {RAGGED_ROWS}; planes kernel on {VIEW_COLS}-column views "
        f"(ld, first column, n_rows) {VIEW_SLICES}")
    return err


def phase_commit(rng, dev, smi: str) -> None:
    polys = COMMIT_POLYS
    small = rng.integers(0, P, size=(polys, 1 << COMMIT_CHECK_LOG_ROWS),
                         dtype=np.uint64)
    cap_gpu = commit_cap(GF.from_u64(small, dev), cap_height=4).to_u64()
    cap_cpu = commit_cap(GF.from_u64(small), cap_height=4).to_u64()
    if not np.array_equal(cap_gpu, cap_cpu):
        raise AssertionError("commit_cap on CUDA != plain commit_cap on CPU")
    log(f"commit_cap {polys} x 2^{COMMIT_CHECK_LOG_ROWS}: CUDA cap == CPU "
        f"plain cap")
    n = 1 << COMMIT_LOG_ROWS
    values = random_gf(rng, (polys, n), dev)
    ms = cuda_ms(lambda: commit_cap(values, cap_height=4), reps=5)
    rate = polys * n / (ms / 1e3) / 1e6
    log(f"commit_cap {polys} x 2^{COMMIT_LOG_ROWS} (rate 1, cap 4): "
        f"{ms:.3f} ms, {rate:.2f} Melem/s [{smi}]")


def once_ms(fn):
    """The result of one call and its milliseconds, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(name: str, shape: tuple, clock_mhz: float, sms: int):
    """(bound_ms, bound_by): the least time the card could take for the
    call (`bench.poseidon_bound_ms`)."""
    work = bench.permute_work(*shape) if name in PERMUTES \
        else bench.sponge_work(*shape)
    return bench.poseidon_bound_ms(*work, clock_mhz, sms)


def phase_kernel_times(rng, dev, smi: str, clock_mhz: float) -> dict:
    """Each kernel held against the plain version and timed at the shapes
    its main path gives it. Returns {(name, shape): (ms, plain_ms,
    bound_ms, bound_by)}."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    log(f"bounds: {bench.IMAD_PER_PERMUTATION} IMADs a permutation over "
        f"{sms} SMs x {bench.IMAD_PER_SM_CLOCK} a clock x {clock_mhz:.0f} "
        f"MHz; bytes over {bench.HBM_BYTES_S / 1e12:.2f} TB/s")
    work = [((PERMUTE_BATCHES[-1],), PERMUTES)] \
        + [(shape, SPONGES) for shape in LEAF_SHAPES]
    for shape, names in work:
        x = random_gf(rng, shape if names is SPONGES else shape + (12,), dev)
        if names is SPONGES:
            want, plain_ms = once_ms(lambda: poseidon.hash_rows_plain(x.T))
        else:
            want, plain_ms = once_ms(lambda: poseidon.permute_plain(x))
        for name in names:
            fn = KERNELS[name][2]
            if max_abs_err(fn(x), want):
                raise AssertionError(f"{name} kernel != plain at {shape}")
            ms = cuda_ms(lambda: fn(x), reps=10 if shape[0] < 100 else 3)
            bound_ms, bound_by = bound(name, shape, clock_mhz, sms)
            rows[(name, shape)] = (ms, plain_ms, bound_ms, bound_by)
            log(f"{name} {shape}: kernel == plain; kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) "
                f"[{smi}]")
    return rows


def keccak_host_rows(rows: np.ndarray) -> np.ndarray:
    """keccak256 digests of (n, width) u64 rows by the numpy batch hasher,
    limbs made canonical (merkle/keccak_tree.py)."""
    n, width = rows.shape
    return _digest_reduce(keccak_np.keccak256_batch(
        np.ascontiguousarray(rows).view(np.uint8).reshape(n, width * 8)))


def phase_keccak(rng, dev, smi: str, clock_mhz: float):
    """The keccak256 rows kernel against its plain version, the numpy
    batch hasher and the scalar native keccak256 (exact): rows read
    through the LDE's transposed layout at KECCAK_WIDTHS, the first rows
    each of one boundary value; a compress level of 2^KECCAK_PAIRS_LOG
    pairs; a whole Keccak tree against build_tree_keccak's cap. Then its
    times at Logic's leaves and at the compress level. Returns
    (max_abs_err, {shape: (ms, plain_ms, bound_ms, bound_by)})."""
    err = 0
    uniform = np.array(KECCAK_BOUNDARY, dtype=np.uint64)[None, :]
    for width in KECCAK_WIDTHS:
        m = rng.integers(0, 2**64, size=(width, KECCAK_CHECK_ROWS),
                         dtype=np.uint64)
        m[:, :uniform.shape[1]] = uniform       # row r: one value, all words
        x = GF.from_u64(m, dev).T              # (rows, width) as lde.T
        got = keccak_device.keccak_rows(x)
        err = max(err, max_abs_err(got, keccak_device.keccak_rows_plain(x)))
        out = got.to_u64()
        if err or not np.array_equal(out, keccak_host_rows(m.T)):
            raise AssertionError(f"keccak kernel != plain or numpy at width "
                                 f"{width}")
        for r in range(uniform.shape[1] + 1):
            raw = native.keccak256(m[:, r].astype("<u8").tobytes())
            if [int(v) for v in out[r]] != keccak_host._to_digest(raw):
                raise AssertionError(f"keccak kernel row {r} != native "
                                     f"keccak256 at width {width}")
    level = random_gf(rng, (2 << KECCAK_PAIRS_LOG, 4), dev)
    got = keccak_device.compress(level)
    err = max(err, max_abs_err(got, keccak_device.compress_plain(level)))
    if err or not np.array_equal(got.to_u64(), keccak_host_rows(
            level.to_u64().reshape(-1, 8))):
        raise AssertionError("keccak compress != plain or numpy")
    cols, leaves = KECCAK_TREE_SHAPE
    m = rng.integers(0, P, size=(cols, leaves), dtype=np.uint64)
    tree = build_commitment_tree(GF.from_u64(m, dev).T, 4, "keccak")
    if not np.array_equal(tree.cap_u64(),
                          build_tree_keccak(m.T, 4).cap_u64()):
        raise AssertionError("keccak device tree cap != build_tree_keccak")
    try:
        build_commitment_tree(GF.from_u64(m, dev).T, 4, "keccak_host")
    except ValueError:
        pass
    else:
        raise AssertionError('hasher="keccak_host" took leaves on the card')
    log(f"keccak: kernel == plain == numpy == native keccak256 (exact) at "
        f"widths {KECCAK_WIDTHS} x {KECCAK_CHECK_ROWS} rows (boundary "
        f"values {KECCAK_BOUNDARY}), 2^{KECCAK_PAIRS_LOG} compress pairs; a "
        f"{cols} x 2^{leaves.bit_length() - 1} tree's cap == "
        f"build_tree_keccak's")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"keccak bound: {bench.INT_OPS_PER_KECCAK} logic instructions a "
        f"permutation over {sms} SMs x {bench.INT_OPS_PER_SM_CLOCK} a clock "
        f"x {clock_mhz:.0f} MHz; bytes over {bench.HBM_BYTES_S / 1e12:.2f} "
        f"TB/s")
    rows = {}
    # Logic's leaves as the prover hands them over (lde.T), and a compress
    # level as compress reads it (the digests' contiguous (n, 8) view)
    for shape, transposed in (((2 << LOGIC_LOG_ROWS, logic.NUM_COLUMNS),
                               True),
                              ((1 << KECCAK_PAIRS_LOG, 8), False)):
        n, width = shape
        x = random_gf(rng, (width, n), dev).T if transposed \
            else random_gf(rng, shape, dev)
        want, plain_ms = once_ms(lambda: keccak_device.keccak_rows_plain(x))
        if max_abs_err(keccak_device.keccak_rows(x), want):
            raise AssertionError(f"keccak kernel != plain at {shape}")
        ms = cuda_ms(lambda: keccak_device.keccak_rows(x), reps=10)
        bound_ms, bound_by = bench.keccak_bound_ms(
            *bench.keccak_work(n, width), clock_mhz, sms)
        rows[shape] = (ms, plain_ms, bound_ms, bound_by)
        log(f"keccak_rows {shape}: kernel == plain; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) "
            f"[{smi}]")
    return err, rows


def logic_trace(rng, log_rows: int) -> np.ndarray:
    n = 1 << log_rows
    ops = [(("and", "or", "xor")[int(k)],
            int.from_bytes(rng.bytes(32), "little"),
            int.from_bytes(rng.bytes(32), "little"))
           for k in rng.integers(0, 3, size=n)]
    return logic.generate_trace(ops, min_rows=n)


def logic_small_proof(trace: np.ndarray, hasher: str, device) -> str:
    cfg = dataclasses.replace(StarkConfig.test_config(), hasher=hasher)
    return proof_to_json(prove_stark(logic.LogicStark(), trace, cfg,
                                     Challenger(), device=device))


def chain_small_proof(device) -> str:
    traces, starks, ctls, _ = chain_inputs(CHAIN_CHECK_WORDS)
    return proof_to_json(prove_all(starks, traces, ctls,
                                   StarkConfig.test_config(), device=device))


def cdk_proof(device) -> str:
    traces, starks, ctls, _ = cdk_inputs()
    cfg = StarkConfig(security_bits=1, fri_config=FriConfig(**CDK_CFG_KW))
    return proof_to_json(prove_all(starks, traces, ctls, cfg, device=device))


def on_cpu(fn, *args):
    """(fn(*args, device="cpu"), its seconds): a CPU reference proof, run
    in the reference process."""
    t0 = time.perf_counter()
    out = fn(*args, device="cpu")
    return out, time.perf_counter() - t0


def reference_process_init() -> None:
    """The reference process yields the host's cores to the card's
    phases, whose timed work is host-bound: lowest priority, and
    CPU_REFERENCE_THREADS torch threads."""
    os.nice(19)
    torch.set_num_threads(CPU_REFERENCE_THREADS)


def start_cpu_references(logic_traces: dict):
    """The CPU reference proofs that the card's proofs must equal byte for
    byte (LogicStark 2^12 under each hasher, the 2^10 memory chain, the
    cdk scenario), made in one process of their own while the card's
    phases run. Returns (executor, {name: future})."""
    pool = ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"),
        initializer=reference_process_init)
    futures = {}                              # in the order main needs them
    futures["logic poseidon"] = pool.submit(
        on_cpu, logic_small_proof, logic_traces["poseidon"], "poseidon")
    futures["chain"] = pool.submit(on_cpu, chain_small_proof)
    futures["logic keccak"] = pool.submit(
        on_cpu, logic_small_proof, logic_traces["keccak"], "keccak")
    futures["cdk"] = pool.submit(on_cpu, cdk_proof)
    return pool, futures


def phase_logic_small(trace: np.ndarray, reference, dev,
                      hasher: str = "poseidon") -> None:
    t0 = time.perf_counter()
    on_gpu = logic_small_proof(trace, hasher, dev)
    t1 = time.perf_counter()
    want, cpu_s = reference.result()
    if on_gpu != want:
        raise AssertionError(f"LogicStark, hasher {hasher}: CUDA proof != "
                             f"CPU proof")
    log(f"LogicStark 2^{LOGIC_CHECK_LOG_ROWS} test config, hasher {hasher}: "
        f"CUDA proof == CPU proof ({len(on_gpu)} bytes; CUDA {t1 - t0:.2f} "
        f"s, CPU {cpu_s:.2f} s in the reference process)")


def print_tree(tree: TimingTree) -> None:
    def walk(node, depth):
        log(f"  {'  ' * depth}{node.elapsed:9.3f} s  {node.name}")
        for child in node.children:
            walk(child, depth + 1)
    for node in tree.root.children:
        walk(node, 0)


def check_launches(launches: dict, hasher: str, what: str) -> None:
    """The kernels a proof under `hasher` launches: the Poseidon permute
    (the proof-of-work grind, and the tree levels under Poseidon) and the
    leaf hash of its trees; under Keccak, never the Poseidon sponge."""
    leaf = "poseidon_sponge" if hasher == "poseidon" else "keccak_rows"
    for name in ("poseidon_permute", leaf):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched in {what}")
    if hasher != "poseidon" and launches["poseidon_sponge"]:
        raise AssertionError(f"the Poseidon sponge launched in {what} under "
                             f"hasher {hasher}")


def phase_logic_full(rng, dev, smi: str, hasher: str = "poseidon") -> dict:
    trace = logic_trace(rng, LOGIC_LOG_ROWS)
    cfg = dataclasses.replace(StarkConfig.standard_fast_config(),
                              hasher=hasher)
    stark = logic.LogicStark()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    tree = TimingTree(f"prove LogicStark 2^{LOGIC_LOG_ROWS}")
    with tree:
        with timed("commit trace"):
            batch = PolynomialBatch.from_values(
                GF.from_u64(trace, dev), rate_bits=cfg.rate_bits,
                cap_height=cfg.cap_height, hasher=cfg.hasher)
        proof = prove_stark(stark, trace, cfg, Challenger(),
                            trace_batch=batch)
    launches = read_counts()
    if batch.lde.device.type != "cuda":
        raise AssertionError(f"trace LDE on {batch.lde.device}, not cuda")
    check_launches(launches, hasher, f"LogicStark under {hasher}")
    log(f"LogicStark 2^{LOGIC_LOG_ROWS} standard config, hasher {hasher}, "
        f"{len(proof.fri_proof.query_rounds)} queries, pow witness "
        f"{proof.fri_proof.pow_witness} [{smi}]:")
    print_tree(tree)
    log(f"  {tree.root.elapsed:9.3f} s  total; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    verify_stark(stark, proof, cfg, Challenger())
    log(f"LogicStark 2^{LOGIC_LOG_ROWS} verified by the port's verifier in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    return launches


def phase_bench(smi: str) -> dict:
    """The benchmark entry point, through the command line's `bench`
    (`bench.main()`), then the layout comparison; their JSON lines are
    logged and printed."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rc, _ = run_cli(["bench"])
    if rc != 0:
        raise AssertionError(f"bench: exit {rc}")
    bench.compare_poseidon_layouts()
    launches = read_counts()
    for name in PERMUTES + SPONGES:            # the Poseidon kernels it runs
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched in the "
                                 f"benchmark")
    log(f"bench: main() and compare_poseidon_layouts() in "
        f"{time.perf_counter() - t0:.2f} s [{smi}]; launches {launches}")
    return launches


def chain_inputs(n_words: int):
    traces = chain_traces(preinitialized_words(n_words, seed=SEED))
    optional = tuple(i for i, t in enumerate(traces) if t is None)
    return (traces, all_stark.all_starks(),
            all_stark.all_cross_table_lookups(), optional)


def phase_chain_small(reference, dev) -> None:
    t0 = time.perf_counter()
    on_gpu = chain_small_proof(dev)
    t1 = time.perf_counter()
    want, cpu_s = reference.result()
    if on_gpu != want:
        raise AssertionError("memory chain: CUDA proof != CPU proof")
    log(f"memory chain, {CHAIN_CHECK_WORDS} words, test config: CUDA proof "
        f"== CPU proof ({len(on_gpu)} bytes; CUDA {t1 - t0:.2f} s, CPU "
        f"{cpu_s:.2f} s in the reference process)")


def proof_sha256(proof) -> str:
    return hashlib.sha256(proof_to_json(proof).encode()).hexdigest()


def stage_seconds(tree: TimingTree) -> dict:
    """Seconds of each of STAGES, summed over the tree (every table)."""
    out = dict.fromkeys(STAGES, 0.0)
    names = {v: k for k, v in STAGES.items()}

    def walk(node):
        if node.name in names:
            out[names[node.name]] += node.elapsed
        for child in node.children:
            walk(child)
    walk(tree.root)
    return out


def commit_seconds(tree: TimingTree) -> float:
    """Seconds of the commitments (the outermost "commit ..." scopes),
    summed over the tree."""
    def walk(node):
        if node.name.startswith("commit "):
            return node.elapsed
        return sum(walk(child) for child in node.children)
    return walk(tree.root)


def log_prove_tree(tree: TimingTree, launches: dict) -> None:
    """A proof's timing tree, then its total, the commitments' and
    STAGES' seconds over every table, the peak and the launches."""
    print_tree(tree)
    log(f"  {tree.root.elapsed:9.3f} s  total; stages (all tables) "
        f"commit {commit_seconds(tree):.2f}, "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage_seconds(tree).items())
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")


def phase_chain_full(dev, smi: str, hasher: str = "poseidon") -> tuple:
    """The 2^20-row chain proved and verified: (launches, sha256 of the
    proof's JSON, seconds of each of STAGES)."""
    t0 = time.perf_counter()
    traces, starks, ctls, optional = chain_inputs(CHAIN_WORDS)
    in_use = {name: traces[getattr(all_stark.Table, name)].shape
              for name in ("Memory", "MemBefore", "MemAfter")}
    log(f"memory chain traces {in_use} from {CHAIN_WORDS} words in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    for shape in in_use.values():
        if shape[1] != 1 << CHAIN_LOG_ROWS:
            raise AssertionError(f"chain trace {shape}, not 2^"
                                 f"{CHAIN_LOG_ROWS} rows")
    cfg = dataclasses.replace(StarkConfig.standard_fast_config(),
                              hasher=hasher)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    tree = TimingTree(f"prove memory chain, hasher {hasher}")
    with tree:
        proof = prove_all(starks, traces, ctls, cfg, device=dev)
    launches = read_counts()
    check_launches(launches, hasher, f"the memory chain under {hasher}")
    log(f"memory chain 2^{CHAIN_LOG_ROWS} standard config, hasher {hasher} "
        f"(tables in order Memory, MemBefore, MemAfter) [{smi}]:")
    print_tree(tree)
    log(f"  {tree.root.elapsed:9.3f} s  total; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    t0 = time.perf_counter()
    verify_all(starks, proof, ctls, cfg, optional_tables=optional)
    log(f"memory chain ({hasher}) verified by the port's verify_all in "
        f"{time.perf_counter() - t0:.2f} s")
    return launches, proof_sha256(proof), stage_seconds(tree)


def cdk_inputs(mutate=None, general_blocks: int = 1):
    """The cdk_erigon scenario's traces (changed by `mutate`), starks,
    CTLs and optional tables."""
    traces, cpu_stark = build_cdk_poseidon_scenario(general_blocks)
    if mutate is not None:
        mutate(traces)
    starks = all_stark.all_starks("cdk_erigon")
    starks[all_stark.Table.Cpu] = cpu_stark
    optional = tuple(i for i, t in enumerate(traces) if t is None)
    return traces, starks, all_stark.all_cross_table_lookups("cdk_erigon"), \
        optional


def wrong_memory_byte(traces) -> None:
    """Flip a byte the Poseidon coprocessor reads from Memory."""
    mtrace = traces[all_stark.Table.Memory]
    rows = np.nonzero(mtrace[memory.ADDR_SEGMENT]
                      == int(Segment.KernelGeneral))[0]
    mtrace[memory.VALUE_COLS[0], int(rows[0])] ^= 1


def wrong_digest(traces) -> None:
    """Change the CPU's claimed simple digest (next row's stack top)."""
    traces[all_stark.Table.Cpu][cc.MEM_CHANNELS[0].value[0], 1] ^= 1


def phase_cdk(reference, dev, smi: str) -> None:
    """The cdk_erigon table set: the Poseidon coprocessor scenario, its
    ten tables under one transcript, proved on the card."""
    traces, starks, ctls, optional = cdk_inputs()
    names = {v: k for k, v in vars(all_stark.Table).items()
             if isinstance(v, int)}
    shapes = {names[i]: t.shape for i, t in enumerate(traces)
              if t is not None}
    cfg = StarkConfig(security_bits=1, fri_config=FriConfig(**CDK_CFG_KW))
    zero_counts()
    t0 = time.perf_counter()
    proof = prove_all(starks, traces, ctls, cfg, device=dev)
    t1 = time.perf_counter()
    launches = read_counts()
    check_launches(launches, "poseidon", "the cdk scenario")
    on_gpu = proof_to_json(proof)
    want, cpu_s = reference.result()
    t2 = time.perf_counter()
    if on_gpu != want:
        raise AssertionError("cdk scenario: CUDA proof != CPU proof")
    digest = hashlib.sha256(on_gpu.encode()).hexdigest()
    if digest != CDK_SCENARIO_SHA256:
        raise AssertionError(f"cdk scenario sha256 {digest} != the JAX "
                             f"package's {CDK_SCENARIO_SHA256}")
    verify_all(starks, proof, ctls, cfg, optional_tables=optional)
    log(f"cdk_erigon scenario {shapes}, test config: proved on the card in "
        f"{t1 - t0:.2f} s (CPU {cpu_s:.2f} s in the reference process), "
        f"launches {launches}; CUDA "
        f"proof == CPU proof, sha256 == the JAX package's {digest[:8]}…; "
        f"verify_all accepts it in {time.perf_counter() - t2:.2f} s [{smi}]")
    # the standard config commits no table under 8 rows (a height-4 cap
    # at rate 2^-1): a 7-block POSEIDON_GENERAL fills an 8-row Poseidon
    # table with real rows
    std = StarkConfig.standard_fast_config()
    traces, starks, ctls, optional = cdk_inputs(general_blocks=7)
    shapes = {names[i]: t.shape for i, t in enumerate(traces)
              if t is not None}
    short = {name: shape[1] for name, shape in shapes.items()
             if shape[1] << std.rate_bits < 1 << std.cap_height}
    if short:
        raise AssertionError(f"cdk scenario: {short} rows are too few for "
                             f"the standard config")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = prove_all(starks, traces, ctls, std, device=dev)
    t1 = time.perf_counter()
    launches = read_counts()
    check_launches(launches, "poseidon", "the standard-config cdk scenario")
    verify_all(starks, proof, ctls, std, optional_tables=optional)
    log(f"cdk_erigon scenario with a 7-block POSEIDON_GENERAL {shapes}, "
        f"standard config ({std.fri_config.num_query_rounds} queries, cap "
        f"height {std.cap_height}): proved on the card in {t1 - t0:.2f} s, "
        f"launches {launches}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; verify_all "
        f"accepts it in {time.perf_counter() - t1:.2f} s (a correctness "
        f"check at toy size, not a measurement of a cdk block) [{smi}]")
    for what, mutate in (("a wrong memory byte", wrong_memory_byte),
                         ("a wrong digest", wrong_digest)):
        traces, starks, ctls, optional = cdk_inputs(mutate)
        bad = prove_all(starks, traces, ctls, cfg, device=dev)
        try:
            verify_all(starks, bad, ctls, cfg, optional_tables=optional)
        except AssertionError:
            log(f"cdk_erigon scenario with {what}: proved on the card, "
                f"rejected by verify_all")
        else:
            raise AssertionError(f"the cdk scenario with {what} verified")


def run_cli(argv: list) -> tuple:
    """`python3 -m zk_evm_tpu_torch ARGV` in this process; its standard
    output and error are logged. Returns (exit code, standard output)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    log(f"$ python3 -m zk_evm_tpu_torch {' '.join(argv)}  -> exit {rc} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in (err.getvalue() + out.getvalue()).splitlines():
        log(f"  | {line}")
    return rc, out.getvalue()


def tamper_public_value(path: Path, out: Path) -> None:
    """The block proof at `path` with block_gas_used of the first
    segment's public values raised by one and its public inputs
    re-encoded to match: only the transcript can reject it."""
    d = json.loads(path.read_text())
    seg = d["batches"][0][0]
    seg["public_values"]["block_metadata"]["block_gas_used"] += 1
    seg["public_inputs"] = public_values_from_dict(
        seg["public_values"]).to_elements()
    out.write_text(json.dumps(d))


def block_shapes(path: Path) -> list:
    """Per segment, {table: log2 rows} of the proofs in a block file."""
    names = {v: k for k, v in vars(all_stark.Table).items()
             if isinstance(v, int)}
    d = json.loads(path.read_text())
    return [{names[t]: p["degree_bits"] for t, p in enumerate(seg["proofs"])
             if p is not None} for chain in d["batches"] for seg in chain]


def prove_and_verify_fixture(fixture: str, extra: list, segments: int,
                             smi: str) -> dict:
    """`prove` then `verify` of a fixture block through the command line,
    and `verify` of the proof with one public value changed, the two
    `verify` runs in processes of their own at once. Returns the kernels'
    launches during `prove`."""
    proof = BLOCK_DIR / f"{fixture}.zkproof"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    rc, out = run_cli(["prove", "--fixture", fixture, *extra, "--device",
                       "cuda", "-o", str(proof)])
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if rc != 0:
        raise AssertionError(f"prove --fixture {fixture}: exit {rc}")
    summary = json.loads(out.strip().splitlines()[-1])
    if summary["segments"] != [segments]:
        raise AssertionError(f"{fixture}: {summary['segments']} segments, "
                             f"expected [{segments}]")
    for name in ("poseidon_permute", "poseidon_sponge"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched proving "
                                 f"{fixture}")
    log(f"{fixture}: proved in {seconds:.2f} s at the standard config "
        f"[{smi}]; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}; state_root_after {summary['state_root_after']}; "
        f"log2 rows per segment {block_shapes(proof)}")
    bad = BLOCK_DIR / f"{fixture}-tampered.zkproof"
    tamper_public_value(proof, bad)
    results = run_cli_processes({
        "block": ["verify", str(proof), "--device", "cuda"],
        "tampered": ["verify", str(bad), "--device", "cuda"]})
    rc, out, _ = results["block"]
    if rc != 0 or not json.loads(out.strip().splitlines()[-1])["ok"]:
        raise AssertionError(f"verify rejected the {fixture} block proof")
    if results["tampered"][0] != 1:
        raise AssertionError(f"verify of the tampered {fixture} proof: exit "
                             f"{results['tampered'][0]}, expected 1")
    log(f"{fixture}: verify accepts the block proof in "
        f"{results['block'][2]:.2f} s and rejects it with block_gas_used + 1 "
        f"in segment 0 in {results['tampered'][2]:.2f} s [{smi}]")
    return launches


def phase_block(dev, smi: str) -> dict:
    """The block path through the command line; returns the dense
    kernels' launches while proving simple-transfer."""
    t0 = time.perf_counter()
    lib = native.build()
    if not native_vm.available():
        raise AssertionError("the native VM core did not load")
    kernel = combined_kernel()
    model = type(Interpreter(kernel, 0).memory).__name__
    if model != "NativeMemory":
        raise AssertionError(f"witness memory model {model}, not native")
    log(f"native/ built into {lib.name} and loaded in "
        f"{time.perf_counter() - t0:.2f} s; witness memory model {model}")
    BLOCK_DIR.mkdir(parents=True, exist_ok=True)
    # add11, the fixture's contract call, proves in the witness phase
    launches = prove_and_verify_fixture(
        "simple-transfer", ["--max-cpu-len-log", str(BLOCK_SEGMENT_LOG)], 2,
        smi)
    # one simple-transfer segment at the test config and default table
    # sizes against the JAX package's proof
    if os.environ.get("ZK_TABLE_MIN_DEGREES"):
        raise AssertionError("ZK_TABLE_MIN_DEGREES is set: the test-config "
                             "segment needs the default table sizes")
    cfg = StarkConfig.test_config()
    t0 = time.perf_counter()
    ((_, gt),) = generate_segment_tables(
        kernel, FIXTURES["simple-transfer"](), max_cpu_len_log=16)
    t1 = time.perf_counter()
    proof = prove_block(gt, cfg, device=dev)
    t2 = time.perf_counter()
    text = proof_to_json(proof)
    (BLOCK_DIR / "simple-transfer-test-config.json").write_text(text)
    digest = hashlib.sha256(text.encode()).hexdigest()
    if digest != SIMPLE_TRANSFER_TEST_CONFIG_SHA256:
        raise AssertionError(f"test-config segment: sha256 {digest} != the "
                             f"JAX package's "
                             f"{SIMPLE_TRANSFER_TEST_CONFIG_SHA256}")
    verify_block(proof, kernel, cfg, device=dev)
    log(f"simple-transfer, 1 segment, test config: witness {t1 - t0:.2f} s, "
        f"prove {t2 - t1:.2f} s, verify {time.perf_counter() - t2:.2f} s; "
        f"proof_to_json sha256 == the JAX package's {digest}")
    return launches


def run_cli_processes(commands: dict) -> dict:
    """Each `python3 -m zk_evm_tpu_torch ARGV` of `commands` (name ->
    argv) in a process of its own, all started together and waited for;
    their output is logged. Returns name -> (exit code, standard output,
    seconds from the start to that process's exit). Every process is
    ended before this returns, whatever happens."""
    procs, done = {}, {}
    t0 = time.perf_counter()

    def wait(name):
        stdout, stderr = procs[name].communicate(timeout=600)
        done[name] = (procs[name].returncode, stdout, stderr,
                      time.perf_counter() - t0)
    try:
        for name, argv in commands.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "zk_evm_tpu_torch", *argv], cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        with ThreadPoolExecutor(max_workers=len(procs)) as pool:
            for f in [pool.submit(wait, name) for name in procs]:
                f.result()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for name, (rc, stdout, stderr, seconds) in done.items():
        log(f"$ python3 -m zk_evm_tpu_torch {' '.join(commands[name])}  -> "
            f"exit {rc} in {seconds:.2f} s (one of {len(procs)} run "
            f"together)")
        for line in (stderr + stdout).splitlines():
            log(f"  | {line}")
        out[name] = (rc, stdout, seconds)
    return out


def phase_witness(smi: str) -> dict:
    """A chain of two blocks from one witness file, through the command
    line: add11 (checkpoint-anchored) and its txn-less child with one
    withdrawal, each decoded into two batches (the child's both dummy),
    proved at the standard config and chained; then `verify` of both
    block proofs, of their refusals, and of the JAX package's mainnet
    proof of block 1033, batch 0. Returns the dense kernels' launches
    while proving the chain."""
    path = witness_chain_file()
    wdir = path.parent
    witnesses = json.loads(path.read_text())
    _, roots = build_witness_chain(WITNESS_FIXTURE)

    rc, out = run_cli(["decode", str(path)])
    decoded = [json.loads(line) for line in out.strip().splitlines()]
    want = [{"post_state_root": "0x" + r.state_root.hex(),
             "transactions_root": "0x" + r.transactions_root.hex(),
             "receipts_root": "0x" + r.receipts_root.hex()} for r in roots]
    got = [{k: d[k] for k in want[0]} for d in decoded]
    if rc != 0 or got != want:
        raise AssertionError(f"decode: exit {rc}, roots {got} != the "
                             f"fixture's {want}")
    if [d["batches"] for d in decoded] != WITNESS_BATCHES \
            or [d["checkpoint_ok"] for d in decoded] != [True, False]:
        raise AssertionError(f"decode: {decoded}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(wdir):              # b{n}.zkproof land here
        rc, out = run_cli(["prove", "--witness", str(path), "--device",
                           "cuda"])
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if rc != 0:
        raise AssertionError(f"prove --witness: exit {rc}")
    summary = json.loads(out.strip().splitlines()[-1])
    if summary["batches"] != WITNESS_BATCHES \
            or summary["state_root_after"] != want[-1]["post_state_root"]:
        raise AssertionError(f"prove --witness: {summary}")
    for name in ("poseidon_permute", "poseidon_sponge"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched proving the "
                                 f"witness chain")
    proofs = [wdir / p for p in summary["proofs"]]
    log(f"witness chain: {len(proofs)} blocks, batches "
        f"{summary['batches']}, segments {summary['segments']}, proved in "
        f"{seconds:.2f} s at the standard config [{smi}]; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}; log2 rows per segment "
        f"{[block_shapes(p) for p in proofs]}")
    blocks = [block_proof_from_json(p.read_text()) for p in proofs]
    t0 = time.perf_counter()
    verify_block_chain(blocks, combined_kernel(), reverify=False,
                       checkpoint_state_trie_root=bytes.fromhex(
                           witnesses[0]["other_data"]
                           ["checkpoint_state_trie_root"][2:]))
    log(f"verify_block_chain: block A anchored at its checkpoint, block B "
        f"linked to A, in {time.perf_counter() - t0:.2f} s")

    block_a, block_b = proofs
    bad = wdir / "block-a-tampered.zkproof"
    tamper_public_value(block_a, bad)
    b1033 = wdir / "b1033_batch0.zkproof"
    with gzip.open(B1033_PROOF) as src, open(b1033, "wb") as dst:
        shutil.copyfileobj(src, dst)
    want_rc = {"A --checkpoint": 0, "B": 0, "B --checkpoint": 1,
               "A tampered": 1, "b1033 batch 0": 0}
    results = run_cli_processes({
        "A --checkpoint": ["verify", str(block_a), "--checkpoint"],
        "B": ["verify", str(block_b)],
        "B --checkpoint": ["verify", str(block_b), "--checkpoint"],
        "A tampered": ["verify", str(bad)],
        "b1033 batch 0": ["verify", str(b1033)],
    })
    got_rc = {name: r[0] for name, r in results.items()}
    if got_rc != want_rc:
        raise AssertionError(f"verify exit codes {got_rc} != {want_rc}")
    segments = json.loads(results["b1033 batch 0"][1].strip()
                          .splitlines()[-1])["segments"]
    log(f"verify [{smi}]: " + "; ".join(
        f"{name} exit {r[0]} in {r[2]:.2f} s" for name, r in results.items())
        + f"; b1033 batch 0 ({segments} segments, the JAX package's mainnet "
        f"proof) accepted on the card")
    return launches


class FibStark(Stark):
    """tests/test_stark.py's Fibonacci-with-product AIR: x0, x1, x0*x1."""
    name = "fib"
    num_columns = 3
    num_public_inputs = 3

    def eval(self, frame, cc):
        x0, x1, prod = frame.local
        n0, n1, _ = frame.next
        pi = frame.public_inputs
        cc.constraint(prod - x0 * x1)
        cc.constraint_transition(n0 - x1)
        cc.constraint_transition(n1 - (x0 + x1))
        cc.constraint_first_row(x0 - pi[0])
        cc.constraint_first_row(x1 - pi[1])
        cc.constraint_last_row(x1 - pi[2])


def fib_trace(n: int):
    rows = np.zeros((3, n), dtype=np.uint64)
    x0, x1 = 1, 2
    for i in range(n):
        rows[:, i] = (x0, x1, host.fmul(x0, x1))
        x0, x1 = x1, host.fadd(x0, x1)
    return rows, [1, 2, int(rows[1, n - 1])]


def tape_sha256(rvm_trace: np.ndarray, ram_trace: np.ndarray) -> str:
    h = hashlib.sha256(np.ascontiguousarray(rvm_trace).tobytes())
    h.update(np.ascontiguousarray(ram_trace).tobytes())
    return h.hexdigest()


def phase_wrap_small(dev) -> None:
    """A 16-row Fibonacci proof verified in a tape; the tape's proof on
    the card equals the JAX package's, whose sha256 tier-1's
    tests/test_torch_recursion.py holds the port's CPU proof to as well
    (the CPU proof takes about 40 s, so it is not made here)."""
    trace, pis = fib_trace(FIB_ROWS)
    ccfg = StarkConfig(security_bits=1, fri_config=FriConfig(**FIB_CHILD_KW))
    ocfg = StarkConfig(security_bits=1, fri_config=FriConfig(**FIB_OUTER_KW))
    child = prove_stark(FibStark(), trace, ccfg, Challenger(), pis,
                        device=dev)
    t = vm.Tape(npub=3)
    if not isinstance(t, vm.NativeTape):
        raise AssertionError(f"Tape() gave {type(t).__name__}")
    for k, c in enumerate(verify_stark_tape(t, FibStark(), child,
                                            ccfg).public_inputs):
        t.bind_public(c, k)
    zero_counts()
    t0 = time.perf_counter()
    starks, proof, pub = prove_system(t, ocfg, device=dev)
    t1 = time.perf_counter()
    launches = read_counts()
    for name in ("poseidon_permute", "poseidon_sponge"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched in the "
                                 f"Fibonacci wrap")
    digest = hashlib.sha256(proof_to_json(proof).encode()).hexdigest()
    if digest != FIB_WRAP_SHA256:
        raise AssertionError(f"Fibonacci wrap sha256 {digest} != the JAX "
                             f"package's {FIB_WRAP_SHA256}")
    verify_system(starks, proof, ocfg, expected_public_inputs=pis,
                  device=dev)
    log(f"Fibonacci wrap: {len(t.rows)}-op tape; prove_system on the card "
        f"{t1 - t0:.2f} s, launches {launches}; proof_to_json sha256 == "
        f"the JAX package's {digest[:8]}… (the CPU proof's in tier-1); "
        f"verify_system accepts it in {time.perf_counter() - t1:.2f} s")


def change_opening(stark_proof, oracle: int) -> None:
    """Change one FRI opening of a table's proof in place: the first
    query's leaf of one of its oracles."""
    leaves = stark_proof.fri_proof.query_rounds[0].initial.leaves
    leaves[oracle] = [(int(leaves[oracle][0]) + 1) % P] \
        + list(leaves[oracle][1:])


def tampered_opening(proof):
    """A copy of a 3-table wrap proof with one FRI opening changed: the
    first query's leaf of the Rvm's witness oracle."""
    bad = copy.deepcopy(proof)
    change_opening(bad.proofs[RVM], 1)
    return bad


def tampered_child(ap):
    """A copy of a segment proof with block_gas_used + 1 in its public
    values and its public inputs re-encoded to match."""
    pv = ap.public_values
    pv = dataclasses.replace(pv, block_metadata=dataclasses.replace(
        pv.block_metadata,
        block_gas_used=pv.block_metadata.block_gas_used + 1))
    return dataclasses.replace(ap, public_values=pv,
                               public_inputs=pv.to_elements())


def witness_chain_file() -> Path:
    """The two-block witness list of WITNESS_FIXTURE (add11 and its
    txn-less child), written once under BLOCK_DIR."""
    path = BLOCK_DIR / "witness" / f"{WITNESS_FIXTURE}-chain.json"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        witnesses, _ = build_witness_chain(WITNESS_FIXTURE)
        path.write_text(json.dumps(witnesses))
    return path


def tape_shapes(t) -> tuple:
    """Finalize a tape: (Rvm shape, RAM shape, Poseidon permutations,
    sha256 of its Rvm and RAM traces, finalize seconds)."""
    t0 = time.perf_counter()
    _, rvm_trace, ram_trace, pose_ops, _ = t.finalize()
    return (rvm_trace.shape, ram_trace.shape, len(pose_ops),
            tape_sha256(rvm_trace, ram_trace), time.perf_counter() - t0)


def expect_rejection(what: str, fn, match: str | None = None) -> float:
    """Run `fn`, which must raise AssertionError (whose message holds
    `match`, when given); returns its seconds."""
    t0 = time.perf_counter()
    try:
        fn()
    except AssertionError as e:
        if match is not None and match not in str(e):
            raise
    else:
        raise AssertionError(f"{what} was accepted")
    return time.perf_counter() - t0


def prove_wrap_tape(t, std: StarkConfig, dev, what: str, smi: str) -> tuple:
    """Prove a tape at `std` on the card: one proof when its Rvm has at
    most 2^WRAP_ONE_PROOF_LOG rows, else chunks of 2^WRAP_CHUNK_LOG ops.
    Logs the timing tree, the stages' seconds, the peak and the dense
    pair's launches, and returns (chunks or None, [(starks, proof)],
    public inputs, launches)."""
    chunked = len(t.rows) > 1 << WRAP_ONE_PROOF_LOG
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    tree = TimingTree(f"prove {what}")
    with tree:
        if chunked:
            chunks, proven, pub = prove_chunked(t, std, WRAP_CHUNK_LOG,
                                                device=dev)
        else:
            chunks = None
            starks, proof, pub = prove_system(t, std, device=dev)
            proven = [(starks, proof)]
    launches = read_counts()
    for name in ("poseidon_permute", "poseidon_sponge"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched proving "
                                 f"{what}")
    how = (f"{len(chunks)} chunks of 2^{WRAP_CHUNK_LOG} ops" if chunked
           else "one proof")
    log(f"{what} proved at the standard config, {how} [{smi}]:")
    log_prove_tree(tree, launches)
    if chunks is not None:
        log("  chunks: " + "; ".join(
            f"Rvm {c.rvm_trace.shape}, RvmMem {c.ram_trace.shape}, "
            f"Poseidon {len(c.pose_ops)}" for c in chunks))
    return chunks, proven, pub, launches


def verify_wrap(chunks, proven, std: StarkConfig, want: list, dev) -> tuple:
    """Verify a proved tape (one proof, or chunks) against the public
    inputs `want`, then again with one FRI opening changed, which must
    fail on a Merkle path. Returns both seconds."""
    t0 = time.perf_counter()
    if chunks is not None:
        verify_chunked(chunks, proven, std, expected_public_inputs=want,
                       device=dev)
        bad = list(proven)
        bad[0] = (proven[0][0], tampered_opening(proven[0][1]))
        reject = lambda: verify_chunked(chunks, bad, std, device=dev)
    else:
        ((starks, proof),) = proven
        verify_system(starks, proof, std, expected_public_inputs=want,
                      device=dev)
        reject = lambda: verify_system(starks, tampered_opening(proof), std,
                                       device=dev)
    verify_s = time.perf_counter() - t0
    return verify_s, expect_rejection(
        "a wrap proof with a changed FRI opening", reject, "Merkle")


def phase_wrap(dev, smi: str) -> tuple:
    """simple-transfer's segment chain verified in one tape and the tape
    proved at the standard config; returns the dense kernels' launches
    while proving the tape and the wrap as a (starks, AllProof) pair
    (None when it was chunked)."""
    kernel = combined_kernel()
    cfg = StarkConfig.test_config()
    proofs = []
    t0 = time.perf_counter()
    for _seg, gt in generate_segment_tables(
            kernel, FIXTURES["simple-transfer"](),
            max_cpu_len_log=WRAP_SEGMENT_LOG):
        proofs.append(prove_block(gt, cfg, device=dev))
    t1 = time.perf_counter()
    if len(proofs) < 2:
        raise AssertionError(f"{len(proofs)} segment(s), expected >= 2")
    bp = aggregate_block([proofs], kernel, cfg, device=dev)
    t2 = time.perf_counter()
    stmt = bp.public_values
    log(f"wrap: simple-transfer, {len(proofs)} segments at the test config "
        f"(max_cpu_len_log {WRAP_SEGMENT_LOG}) proved on the card in "
        f"{t1 - t0:.2f} s (witness included); host aggregate_block (every "
        f"segment verified) {t2 - t1:.2f} s [{smi}]")
    try:
        check_checkpoint_block(stmt)
        log("wrap: the block statement is anchored at its checkpoint")
    except AssertionError as e:
        log(f"wrap: the block statement fails check_checkpoint_block ({e});"
            f" the chain is wrapped alone, its statement hashed into 4 "
            f"public inputs")

    t = vm.Tape(npub=4)
    if not isinstance(t, vm.NativeTape):
        raise AssertionError(f"Tape() gave {type(t).__name__}")
    t0 = time.perf_counter()
    pub_cells, _, _ = agg.wrap_segment_chain(t, proofs, kernel, cfg,
                                             device=dev)
    for k, c in enumerate(sponge_hash(t, pub_cells)):
        t.bind_public(c, k)
    build_s = time.perf_counter() - t0
    want = host_poseidon.hash_no_pad([int(v)
                                      for v in proofs[0].public_inputs])
    if t.public_inputs != want:
        raise AssertionError("wrap statement digest != host hash_no_pad")
    value = [t.value(c) for c in pub_cells]
    md = stmt.block_metadata
    if (value[agg.MD_NUMBER] != md.block_number
            or value[agg.MD_CHAIN_ID] != md.block_chain_id
            or value[agg.TRA:agg.TRA + 8] != pvm_h256(
                stmt.trie_roots_after.state_root)):
        raise AssertionError("wrap cells != aggregate_block's statement")
    rvm_shape, ram_shape, n_pose, digest, fin_s = tape_shapes(t)
    log(f"wrap tape: {len(t.rows)} ops built in {build_s:.2f} s (host); "
        f"Rvm {rvm_shape}, RvmMem {ram_shape}, Poseidon {n_pose} "
        f"permutations; finalized in {fin_s:.2f} s; block number "
        f"{md.block_number}, chain id {md.block_chain_id} and new state "
        f"root equal aggregate_block's; tape sha256 {digest}")
    if digest != WRAP_TAPE_SHA256:
        raise AssertionError(f"wrap tape sha256 != the JAX package's "
                             f"{WRAP_TAPE_SHA256}")

    std = StarkConfig.standard_fast_config()
    chunks, proven, _, launches = prove_wrap_tape(t, std, dev, "wrap", smi)
    verify_s, bad_open = verify_wrap(chunks, proven, std, want, dev)
    bad_child = expect_rejection(
        "a wrap of a child with a changed public value",
        lambda: agg.wrap_segment_chain(
            vm.Tape(npub=4), [tampered_child(proofs[0])] + proofs[1:],
            kernel, cfg, device=dev))
    log(f"wrap verified in {verify_s:.2f} s (host); a changed FRI opening "
        f"rejected in {bad_open:.2f} s; a child with block_gas_used + 1 "
        f"failed while its tape was built in {bad_child:.2f} s")
    return launches, None if chunks is not None else proven[0]


def phase_block_wrap(dev, smi: str) -> tuple:
    """add11's block (block A of the witness list) decoded, its batches
    proved at the test config in segments of at most
    2^BLOCK_WRAP_SEGMENT_LOG CPU rows, aggregated on the host, then the
    whole block verified in one tape (`wrap_block`, `bind_block_publics`)
    proved at the standard config as one proof and checked in constant
    size by `verify_block_wrap_chain`, anchored at add11's checkpoint;
    three tampered cases are rejected. Returns the dense kernels'
    launches while proving the tape and the wrap's (starks, AllProof)."""
    witness = json.loads(witness_chain_file().read_text())[0]
    checkpoint = bytes.fromhex(
        witness["other_data"]["checkpoint_state_trie_root"][2:])
    kernel = combined_kernel()
    cfg = StarkConfig.test_config()
    t0 = time.perf_counter()
    gis = entrypoint(parse_block_prover_input(witness))
    rewrite_checkpoint_consolidation([gis])
    t1 = time.perf_counter()
    bp = prove_block_batches(kernel, gis, config=cfg,
                             max_cpu_len_log=BLOCK_WRAP_SEGMENT_LOG,
                             device=dev)
    t2 = time.perf_counter()
    segments = [len(chain) for chain in bp.batches]
    stmt = bp.public_values
    check_checkpoint_block(stmt)
    if stmt.extra_block_data.checkpoint_state_trie_root != checkpoint:
        raise AssertionError("add11's statement names another checkpoint")
    log(f"block wrap: {WITNESS_FIXTURE} decoded in {t1 - t0:.2f} s into "
        f"{len(gis)} batches; segments per batch {segments} at the test "
        f"config (max_cpu_len_log {BLOCK_WRAP_SEGMENT_LOG}) proved on the "
        f"card and aggregated on the host (aggregate_block, every segment "
        f"verified) in {t2 - t1:.2f} s [{smi}]; check_checkpoint_block "
        f"passes")
    if segments != BLOCK_WRAP_SEGMENTS:
        raise AssertionError(f"segments per batch {segments} != "
                             f"{BLOCK_WRAP_SEGMENTS}")

    t = vm.Tape(npub=agg.NPUB_BLOCK)
    if not isinstance(t, vm.NativeTape):
        raise AssertionError(f"Tape() gave {type(t).__name__}")
    t0 = time.perf_counter()
    agg.bind_block_publics(t, agg.wrap_block(t, bp.batches, kernel, cfg,
                                             device=dev))
    build_s = time.perf_counter() - t0
    rvm_shape, ram_shape, n_pose, digest, fin_s = tape_shapes(t)
    log(f"block wrap tape: {len(t.rows)} ops built in {build_s:.2f} s "
        f"(host); Rvm {rvm_shape}, RvmMem {ram_shape}, Poseidon {n_pose} "
        f"permutations; finalized in {fin_s:.2f} s; tape sha256 {digest}")
    if digest != BLOCK_WRAP_TAPE_SHA256:
        raise AssertionError(f"block wrap tape sha256 != the JAX "
                             f"package's {BLOCK_WRAP_TAPE_SHA256}")
    if len(t.rows) > 1 << WRAP_ONE_PROOF_LOG:
        raise AssertionError(f"block wrap tape of {len(t.rows)} ops does "
                             f"not fit one proof")

    std = StarkConfig.standard_fast_config()
    _, ((starks, proof),), pub, launches = prove_wrap_tape(
        t, std, dev, "block wrap", smi)
    t0 = time.perf_counter()
    (final,) = agg.verify_block_wrap_chain(
        [(starks, proof)], std, checkpoint_state_trie_root=checkpoint,
        device=dev)
    verify_s = time.perf_counter() - t0
    md = stmt.block_metadata
    want_rest = [md.block_number, md.block_timestamp] \
        + pvm_h256(stmt.trie_roots_before.state_root) \
        + list(consolidate_hashes(list(stmt.block_hashes.prev_hashes)))
    if final != FinalPublicValues.from_public_values(stmt).to_elements() \
            or pub[25:] != want_rest:
        raise AssertionError(f"block wrap publics {pub} != "
                             f"aggregate_block's statement")
    log(f"block wrap: verify_block_wrap_chain accepts it anchored at "
        f"{WITNESS_FIXTURE}'s checkpoint in {verify_s:.2f} s (host); "
        f"FinalPublicValues (chain id {md.block_chain_id}, checkpoint "
        f"root, new state root, both consolidated hashes), block number "
        f"{md.block_number}, timestamp, pre-state root and the window's "
        f"consolidated hash == aggregate_block's")
    bad_open = expect_rejection(
        "a block wrap with a changed FRI opening",
        lambda: agg.verify_block_wrap_chain(
            [(starks, tampered_opening(proof))], std, device=dev),
        "Merkle")
    bad_root = expect_rejection(
        "the block wrap against a wrong checkpoint root",
        lambda: agg.verify_block_wrap_chain(
            [(starks, proof)], std,
            checkpoint_state_trie_root=bytes(32), device=dev),
        "wrong checkpoint")
    first = bp.batches[0]
    bad_child = expect_rejection(
        "a block wrap of a child with block_gas_used + 1",
        lambda: agg.wrap_block(
            vm.Tape(npub=agg.NPUB_BLOCK),
            [[tampered_child(first[0])] + first[1:]] + bp.batches[1:],
            kernel, cfg, device=dev))
    log(f"block wrap: a changed FRI opening rejected in {bad_open:.2f} s, "
        f"a wrong checkpoint root in {bad_root:.2f} s; a child with "
        f"block_gas_used + 1 failed while its tape was built in "
        f"{bad_child:.2f} s")
    return launches, (starks, proof)


def phase_two_to_one(dev, smi: str, left, right) -> dict:
    """Two standard-config wrap proofs, add11's block wrap (left) and
    simple-transfer's chain wrap (right), verified in one tape
    (`two_to_one_tape`) whose 4 public inputs are the digest of both
    proofs' public inputs; the tape is proved at the standard config
    (in chunks past 2^WRAP_ONE_PROOF_LOG ops) and verified; a changed
    FRI opening in the outer proof and in one child are rejected.
    Returns the dense kernels' launches while proving the tape."""
    if right is None:
        raise AssertionError("the chain wrap was chunked: no one proof to "
                             "aggregate")
    std = StarkConfig.standard_fast_config()
    want = host_poseidon.hash_no_pad(
        [int(v) for v in left[1].public_inputs]
        + [int(v) for v in right[1].public_inputs])
    t = vm.Tape(npub=4)
    t0 = time.perf_counter()
    for k, c in enumerate(agg.two_to_one_tape(t, left, right, std,
                                              device=dev)):
        t.bind_public(c, k)
    build_s = time.perf_counter() - t0
    if t.public_inputs != want:
        raise AssertionError("two-to-one digest != host hash_no_pad of the "
                             "children's public inputs")
    log(f"two-to-one tape: {len(t.rows)} ops built in {build_s:.2f} s "
        f"(host) from two standard-config wraps "
        f"({len(left[1].public_inputs)} and "
        f"{len(right[1].public_inputs)} public inputs); digest == host "
        f"hash_no_pad")
    chunks, proven, pub, launches = prove_wrap_tape(t, std, dev,
                                                    "two-to-one", smi)
    verify_s, bad_open = verify_wrap(chunks, proven, std, want, dev)
    bad_child = expect_rejection(
        "a two-to-one tape over a child with a changed FRI opening",
        lambda: agg.two_to_one_tape(
            vm.Tape(npub=4), (left[0], tampered_opening(left[1])), right,
            std, device=dev))
    log(f"two-to-one verified in {verify_s:.2f} s (host), public inputs == "
        f"hash_no_pad(left || right); a changed FRI opening rejected in "
        f"{bad_open:.2f} s; a child with a changed FRI opening failed "
        f"while its tape was built in {bad_child:.2f} s")
    return launches


def b1033_segments() -> list:
    """The segment AllProofs of B1033_PROOF, loaded as `verify` loads a
    segment list."""
    with gzip.open(B1033_PROOF) as f:
        return [all_proof_from_dict(d) for d in json.loads(f.read())]


def tampered_pow(ap):
    """A copy of a segment proof with its first table's proof-of-work
    witness + 1."""
    first = ap.proofs[0]
    bad = dataclasses.replace(first, fri_proof=dataclasses.replace(
        first.fri_proof, pow_witness=first.fri_proof.pow_witness + 1))
    return dataclasses.replace(ap, proofs=[bad] + list(ap.proofs[1:]))


def chunks_sha256(chunks, keep=lambda ch: None) -> tuple:
    """sha256 over each chunk's Rvm trace's then RAM trace's bytes, in
    order, and the chunks' (before, after) maps; `keep` sees every chunk
    once it is hashed."""
    h = hashlib.sha256()
    maps = []
    for ch in chunks:
        h.update(np.ascontiguousarray(ch.rvm_trace))
        h.update(np.ascontiguousarray(ch.ram_trace))
        maps.append((ch.before, ch.after))
        keep(ch)
    return h.hexdigest(), maps


def b1033_wrap_tape(proofs: list, dev, smi: str):
    """b1033 batch 0's segments verified in one NativeTape at the
    standard config, its statement hashed into 4 public inputs
    (`sponge_hash`); the public inputs must equal the host `hash_no_pad`
    of segment 0's and the statement's cells b1033's public values.
    Returns the tape."""
    kernel = combined_kernel()
    std = StarkConfig.standard_fast_config()
    t = vm.Tape(npub=4)
    if not isinstance(t, vm.NativeTape):
        raise AssertionError(f"Tape() gave {type(t).__name__}")
    t0 = time.perf_counter()
    cells, _, _ = agg.wrap_segment_chain(t, proofs, kernel, std, device=dev)
    for k, c in enumerate(sponge_hash(t, cells)):
        t.bind_public(c, k)
    build_s = time.perf_counter() - t0
    want = host_poseidon.hash_no_pad([int(v)
                                      for v in proofs[0].public_inputs])
    if t.public_inputs != want:
        raise AssertionError("b1033 wrap statement digest != host "
                             "hash_no_pad of segment 0's public inputs")
    value = [t.value(c) for c in cells]
    pv = proofs[0].public_values
    md = pv.block_metadata
    if (value[agg.MD_NUMBER] != md.block_number
            or md.block_number != B1033_BLOCK
            or value[agg.MD_CHAIN_ID] != md.block_chain_id
            or value[agg.TRA:agg.TRA + 8] != pvm_h256(
                pv.trie_roots_after.state_root)):
        raise AssertionError("b1033 wrap cells != its public values")
    log(f"b1033 wrap tape: {len(proofs)} standard-config segments, "
        f"{len(t.rows)} ops built in {build_s:.2f} s (host; the kernel's "
        f"memory cap on the card) [{smi}]; public inputs == host "
        f"hash_no_pad of segment 0's; block number {md.block_number}, "
        f"chain id {md.block_chain_id} and new state root == its public "
        f"values")
    if len(t.rows) != B1033_WRAP_OPS:
        raise AssertionError(f"b1033 wrap tape of {len(t.rows)} ops != "
                             f"{B1033_WRAP_OPS}")
    return t


def check_chunk_maps(maps: list) -> None:
    """Chunk k's exports are chunk k+1's imports; the first chunk imports
    nothing and the last exports nothing."""
    if maps[0][0] != {} or maps[-1][1] != {}:
        raise AssertionError("the first chunk imports or the last exports")
    for k, ((_, after), (before, _)) in enumerate(zip(maps, maps[1:])):
        if after != before:
            raise AssertionError(f"chunk {k}'s exports != chunk {k + 1}'s "
                                 f"imports")


def phase_b1033_wrap(dev, smi: str) -> dict:
    """The JAX package's standard-config proof of mainnet block 1033,
    batch 0 (two segments, all nine tables) verified in one tape, split
    into its B1033_WRAP_CHUNKS chunks of 2^WRAP_CHUNK_LOG ops, every
    chunk hashed (B1033_WRAP_TAPE_SHA256) and its boundary maps chained,
    and B1033_PROVED_CHUNKS of them proved at the standard config and
    verified: a cut in depth. The split and the hash run on a thread
    beside the proofs. A changed chunk opening, a child with
    block_gas_used + 1 and one with a changed proof-of-work witness are
    rejected. Returns the dense kernels' launches on the path."""
    t_phase = time.perf_counter()
    proofs = b1033_segments()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = b1033_wrap_tape(proofs, dev, smi)
    std = StarkConfig.standard_fast_config()
    pub = [int(v) for v in t.public_inputs]
    ready = queue.Queue()

    def keep(ch) -> None:
        if ch.index in B1033_PROVED_CHUNKS:
            ready.put(ch)

    def split_and_hash() -> tuple:
        t0 = time.perf_counter()
        try:
            out = chunks_sha256(iter_split_tape(t, WRAP_CHUNK_LOG), keep)
        finally:
            ready.put(None)
        return out + (time.perf_counter() - t0,)

    proven = {}
    tree = TimingTree("prove b1033 chunks")
    with ThreadPoolExecutor(1) as pool:
        split = pool.submit(split_and_hash)
        with tree:
            while (ch := ready.get()) is not None:
                with tree.scope(f"prove chunk {ch.index}"):
                    proven[ch.index] = (ch, prove_chunk(ch, pub, std,
                                                        device=dev))
        digest, maps, split_s = split.result()
    launches = read_counts()
    for name in ("poseidon_permute", "poseidon_sponge"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched in path 12")
    if len(maps) != B1033_WRAP_CHUNKS \
            or sorted(proven) != sorted(B1033_PROVED_CHUNKS):
        raise AssertionError(f"{len(maps)} chunks, proved {sorted(proven)}")
    log(f"b1033 wrap chunks: {len(maps)} chunks of 2^{WRAP_CHUNK_LOG} ops "
        f"split and hashed in {split_s:.2f} s on a thread beside the "
        f"proofs; sha256 {digest}")
    if digest != B1033_WRAP_TAPE_SHA256:
        raise AssertionError(f"b1033 wrap chunks' sha256 != the JAX "
                             f"package's {B1033_WRAP_TAPE_SHA256}")
    check_chunk_maps(maps)
    log(f"b1033 wrap: chunks {sorted(proven)} of {len(maps)} proved at the "
        f"standard config (a cut in depth: `chip_smoke.py b1033-wrap` "
        f"proves all {len(maps)}) [{smi}]:")
    log_prove_tree(tree, launches)
    log("  chunks: " + "; ".join(
        f"{k}: Rvm {ch.rvm_trace.shape}, RvmMem {ch.ram_trace.shape}, "
        f"Poseidon {len(ch.pose_ops)}, imports {len(ch.before)}, exports "
        f"{len(ch.after)}" for k, (ch, _) in sorted(proven.items())))

    t0 = time.perf_counter()
    for ch, (starks, proof) in proven.values():
        verify_chunk(ch, starks, proof, std, expected_public_inputs=pub,
                     device=dev)
    verify_s = time.perf_counter() - t0
    caps = [[list(map(int, d)) for d in proven[k][1][1].proofs[i].trace_cap]
            for k, i in ((0, AFTER_T), (1, BEFORE_T))]
    if caps[0] != caps[1]:
        raise AssertionError("chunk 0's MemAfter cap != chunk 1's "
                             "MemBefore cap")
    ch, (starks, proof) = proven[0]
    bad_open = expect_rejection(
        "a b1033 wrap chunk with a changed FRI opening",
        lambda: verify_chunk(ch, starks, tampered_opening(proof), std,
                             device=dev), "Merkle")
    kernel = combined_kernel()
    bad = {what: expect_rejection(
        f"a b1033 wrap of a child with {what}",
        lambda: agg.wrap_segment_chain(
            vm.Tape(npub=4), [tamper(proofs[0])] + proofs[1:], kernel, std,
            device=dev), match)
        for what, tamper, match in (
            ("block_gas_used + 1", tampered_child, "tape assert_eq"),
            ("a changed pow_witness", tampered_pow, "exceeds"))}
    log(f"b1033 wrap: {len(proven)} chunks verified in {verify_s:.2f} s "
        f"(host) against hash_no_pad of segment 0's public inputs; chunk "
        f"0's MemAfter cap == chunk 1's MemBefore cap; chunk maps chained; "
        f"a changed FRI opening rejected in {bad_open:.2f} s; "
        + "; ".join(f"a child with {what} failed while its tape was built "
                    f"in {s:.2f} s" for what, s in bad.items())
        + f"; the path {time.perf_counter() - t_phase:.2f} s")
    return launches


def b1033_full_wrap() -> None:
    """`python3 chip_smoke.py b1033-wrap`: path 12 without its cut in
    depth. The whole b1033 wrap tape proved by `prove_chunked` at the
    standard config, every chunk, and `verify_chunked` against hash_no_pad
    of segment 0's public inputs; logs the timing tree, the stages
    summed over the chunks, the peak and the launches."""
    smi = phase_environment()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_run = time.perf_counter()
    phase_build()
    native.build()
    proofs = b1033_segments()
    t = b1033_wrap_tape(proofs, dev, smi)
    std = StarkConfig.standard_fast_config()
    chunks, proven, pub, launches = prove_wrap_tape(t, std, dev,
                                                    "b1033 wrap", smi)
    if len(chunks) != B1033_WRAP_CHUNKS:
        raise AssertionError(f"{len(chunks)} chunks")
    check_chunk_maps([(ch.before, ch.after) for ch in chunks])
    t0 = time.perf_counter()
    verify_chunked(chunks, proven, std, expected_public_inputs=pub,
                   device=dev)
    log(f"b1033 wrap: verify_chunked accepts all {len(chunks)} chunks in "
        f"{time.perf_counter() - t0:.2f} s (host), public inputs == "
        f"hash_no_pad of segment 0's; the run "
        f"{time.perf_counter() - t_run:.2f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# the shape each kernel's row of the kernels line reports: the PoW grind
# batch, the block's widest leaves (Keccak), the commit benchmark's
# leaves; for the Keccak hasher, Logic's leaves (2^17 rows of 523 words)
def http(url: str, job=None, raw: bytes | None = None) -> tuple:
    """(status, JSON body) of a GET, or of a POST of `job` as JSON or of
    `raw` bytes."""
    body = raw if raw is not None else \
        json.dumps(job).encode() if job is not None else None
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_leader(queue: Path, log_path: Path) -> tuple:
    """`python3 -m zk_evm_tpu_torch leader` in a process of its own;
    returns (process, base URL) once /healthz answers."""
    port = free_port()
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "zk_evm_tpu_torch", "leader", "--queue",
         str(queue), "--port", str(port)], cwd=REPO, stdout=log_file,
        stderr=subprocess.STDOUT)
    log_file.close()
    base = f"http://127.0.0.1:{port}"
    deadline = time.perf_counter() + 120
    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"leader exited {proc.returncode}: "
                                 f"{log_path.read_text()}")
        try:
            if http(base + "/healthz") == (200, {"ok": True}):
                return proc, base
        except OSError:
            pass
        time.sleep(0.2)
    proc.kill()
    raise AssertionError("leader did not answer /healthz in 120 s")


def phase_split(timers: dict, job: dict) -> str:
    """Where the prove_block jobs' seconds went, from the `phase.*`
    timers `timing.timed` fed while they ran: the tables' trace commits
    and proofs on the card, the phases inside them, and the rest of the
    jobs (witness run, host self-verify, proof file)."""
    def total(pred):
        return sum(v["total_s"] for k, v in timers.items() if pred(k))
    commits = total(lambda k: k.startswith("phase.commit ")
                    and k.endswith(" trace") and k != "phase.commit trace")
    proofs = total(lambda k: k.startswith("phase.prove "))
    inner = {name: total(lambda k, n=name: k == f"phase.{n}")
             for name in ("generate aux columns", "commit aux",
                          "evaluate quotient", "commit quotient",
                          "openings", "FRI")}
    return (f"of {job['total_s']:.2f} s in the prove_block jobs: trace "
            f"commits {commits:.2f} s, table proofs {proofs:.2f} s ("
            + ", ".join(f"{n} {t:.2f}" for n, t in inner.items())
            + f"), the rest (witness run, host self-verify, proof file, "
            f"the transcript between the tables) "
            f"{job['total_s'] - commits - proofs:.2f} s")


def watch_jobs(base: str, ids: dict, t_submit: float, stop) -> tuple:
    """Poll GET /jobs/<id> as a client would, until every job is done or
    failed or `stop` is set. Records each job's seconds from submission
    to done. Returns (thread, statuses, seconds), filled in place while
    it runs."""
    statuses, seconds = {}, {}

    def loop():
        while not stop.is_set() and len(statuses) < len(ids):
            for name, job_id in ids.items():
                if name in statuses:
                    continue
                _, st = http(f"{base}/jobs/{job_id}")
                if st["status"] in ("done", "failed"):
                    statuses[name] = st
                    seconds[name] = time.perf_counter() - t_submit
            stop.wait(0.25)
    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    return thread, statuses, seconds


def phase_service(smi: str) -> dict:
    """The leader/worker service: a leader (`python3 -m zk_evm_tpu_torch
    leader`) in a process of its own accepts four requests over HTTP; the
    worker (`main(["worker", ...])`, in this process, so that the kernels'
    launches can be read) proves the prove_block job on the card,
    self-verifies and writes its proof. Checks every job's answer and the
    proof of simple-transfer against the JAX worker's (sha256); then
    `verify` of the proof runs in a process of its own, and the phase
    waits for it, so that nothing of it runs on into later timed work.
    (A prove_block job of a witness batch, whose decoder path the witness
    phase runs, is the CPU tests' to hold: tests/test_torch_service.py.)
    Returns the dense kernels' launches while the worker ran."""
    if os.environ.get("ZK_TABLE_MIN_DEGREES"):
        raise AssertionError("ZK_TABLE_MIN_DEGREES is set: the worker "
                             "proves at the default table sizes")
    if SERVICE_DIR.exists():
        shutil.rmtree(SERVICE_DIR)
    queue = SERVICE_DIR / "queue"
    queue.mkdir(parents=True)
    outputs = {"a": SERVICE_DIR / "simple-transfer.zkproof"}
    jobs = {
        "a": {"kind": "prove_block", "fixture": "simple-transfer",
              "output": str(outputs["a"])},
        "c": {"kind": "echo", "payload": {"seed": SEED}},
        "d": {"kind": "no-such-kind"},
    }
    leader, base = start_leader(queue, SERVICE_DIR / "leader.log")
    stop = threading.Event()
    watcher = None
    try:
        t_submit = time.perf_counter()
        ids = {}
        for name, job in jobs.items():
            code, answer = http(base + "/jobs", job)
            if code != 202:
                raise AssertionError(f"POST job ({name}): {code} {answer}")
            ids[name] = answer["job_id"]
        code, answer = http(base + "/jobs", raw=b"{not json")
        if code != 400:
            raise AssertionError(f"malformed POST: {code} {answer}")
        watcher, statuses, seconds = watch_jobs(base, ids, t_submit, stop)
        metrics.REGISTRY.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(["worker", "--queue", str(queue), "--max-jobs",
                           str(SERVICE_JOBS), "--idle-timeout",
                           str(SERVICE_IDLE_S), "--name", "chip-smoke",
                           "--device", "cuda", "--witness-dir",
                           str(SERVICE_DIR), "--output-dir",
                           str(SERVICE_DIR)])
        worker_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        snap = metrics.snapshot()
        if rc != 0 or json.loads(out.strip().splitlines()[-1]) != {
                "jobs_executed": SERVICE_JOBS}:
            raise AssertionError(f"worker: exit {rc}, {out!r}")
        watcher.join(30)
        stop.set()
        for name in jobs:
            code, st = http(f"{base}/jobs/{ids[name]}")
            statuses[name] = st
        log(f"job answers: {statuses}")
        for name in outputs:
            st = statuses[name]
            if st["status"] != "done" or \
                    st["result"]["proof_path"] != str(outputs[name]):
                raise AssertionError(f"prove_block job ({name}): {st}")
        if statuses["c"] != {"status": "done",
                             "result": {"echo": {"seed": SEED}}}:
            raise AssertionError(f"echo job: {statuses['c']}")
        st = statuses["d"]
        if st["status"] != "failed" or \
                "unknown job kind" not in st["error"]["error"]:
            raise AssertionError(f"unknown-kind job: {st}")
        code, answer = http(f"{base}/jobs/0123456789abcdef")
        if (code, answer) != (404, {"status": "unknown"}):
            raise AssertionError(f"unknown job id: {code} {answer}")
        code, leader_metrics = http(base + "/metrics")
        submitted = leader_metrics["counters"].get("leader.jobs_submitted")
        if code != 200 or submitted != SERVICE_JOBS:
            raise AssertionError(f"leader metrics: {code} {leader_metrics}")
        for name in ("poseidon_permute", "poseidon_sponge"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} kernel never launched by the "
                                     f"worker")
        prove_timer = snap["timers"]["job.prove_block"]
        if prove_timer["count"] != 1 or snap["counters"] != {
                "worker.jobs_completed": 2.0, "worker.jobs_failed": 1.0}:
            raise AssertionError(f"worker metrics: {snap['counters']} "
                                 f"{prove_timer}")
        log(f"service: {phase_split(snap['timers'], prove_timer)}")
        log(f"service: worker ran {SERVICE_JOBS} jobs in {worker_s:.2f} s "
            f"[{smi}]; submit-to-done seconds "
            + ", ".join(f"({k}) {v:.2f}" for k, v in seconds.items())
            + f"; job.prove_block {prove_timer}; cycles "
            f"{[statuses[k]['result']['cycles'] for k in outputs]}; peak "
            f"device memory {peak:.2f} GiB; launches {launches}; leader "
            f"counters {leader_metrics['counters']}")

        digest = hashlib.sha256(outputs["a"].read_bytes()).hexdigest()
        if digest != PROVE_BLOCK_SIMPLE_TRANSFER_SHA256:
            raise AssertionError(
                f"prove_block simple-transfer: sha256 {digest} != the JAX "
                f"worker's {PROVE_BLOCK_SIMPLE_TRANSFER_SHA256}")
        log(f"service (a): proof sha256 == the JAX worker's {digest}")
        verified = run_cli_processes(
            {name: ["verify", str(path), "--device", "cuda"]
             for name, path in outputs.items()})
        for name, (rc, stdout, _) in verified.items():
            if rc != 0 or \
                    not json.loads(stdout.strip().splitlines()[-1])["ok"]:
                raise AssertionError(f"verify rejected proof ({name})")
    finally:
        stop.set()
        if watcher is not None:
            watcher.join(30)
        leader.terminate()
        try:
            leader.wait(30)
        except subprocess.TimeoutExpired:
            leader.kill()
            leader.wait()
    return launches


def launches_since(before: dict) -> dict:
    now = read_counts()
    return {name: now[name] - before[name] for name in now}


def tree_launches(n_leaves: int, cap_height: int, k: int) -> tuple:
    """(leaf-hash launches, level launches) of a tree over a k-entry
    mesh: one leaf hash an entry, every entry's subtree levels down to
    one root or its share of the cap, then the top levels on the first
    entry."""
    shard_levels, size = 0, n_leaves
    while size > (1 << cap_height) and size > k:
        shard_levels += 1
        size //= 2
    return k, k * shard_levels + (size.bit_length() - 1 - cap_height)


def phase_mesh_caps(rng, dev, smi: str) -> None:
    """sharded_commit_cap on each mesh: the cap equals commit_cap's, and
    every entry hashed its leaves and its subtree (the dense pair's
    launches of one call, exactly)."""
    polys, n = MESH_COMMIT_SHAPE
    values = random_gf(rng, (polys, n), dev)
    want = commit_cap(values, cap_height=MESH_CAP_HEIGHT).to_u64()
    single_ms = cuda_ms(lambda: commit_cap(values, cap_height=MESH_CAP_HEIGHT),
                        reps=3)
    log(f"commit_cap {polys} x 2^{n.bit_length() - 1} (cap "
        f"{MESH_CAP_HEIGHT}): {single_ms:.3f} ms [{smi}]")
    meshes = [(f"cuda:0 x {k}", Mesh([dev] * k)) for k in MESH_SIZES]
    cards = torch.cuda.device_count()
    if cards > 1 and cards & (cards - 1) == 0:
        meshes.append((f"{cards} cards", make_mesh(cards)))
    for name, mesh in meshes:
        before = read_counts()
        cap = sharded_commit_cap(values, mesh, cap_height=MESH_CAP_HEIGHT)
        got = launches_since(before)
        if not np.array_equal(cap.to_u64(), want):
            raise AssertionError(f"sharded cap over {name} != commit_cap")
        want_n = tree_launches(2 * n, MESH_CAP_HEIGHT, len(mesh))
        if (got["poseidon_sponge"], got["poseidon_permute"]) != want_n:
            raise AssertionError(
                f"sharded cap over {name}: sponge, permute launches "
                f"{got['poseidon_sponge']}, {got['poseidon_permute']}, "
                f"want {want_n}")
        ms = cuda_ms(lambda: sharded_commit_cap(
            values, mesh, cap_height=MESH_CAP_HEIGHT), reps=3)
        log(f"sharded_commit_cap over {name}: cap == commit_cap; {ms:.3f} ms "
            f"beside commit_cap's {single_ms:.3f} ms; one call launches "
            f"sponge {want_n[0]}, permute {want_n[1]} [{smi}]")


def phase_mesh_keccak(rng, dev, smi: str) -> None:
    cols, rows = MESH_KECCAK_SHAPE
    leaves = random_gf(rng, (cols, rows), dev).T
    want = build_commitment_tree(leaves, MESH_CAP_HEIGHT, "keccak").cap_u64()
    single_ms = cuda_ms(lambda: build_commitment_tree(
        leaves, MESH_CAP_HEIGHT, "keccak"), reps=3)
    mesh = Mesh([dev] * 2)
    before = read_counts()
    tree = build_commitment_tree(leaves, MESH_CAP_HEIGHT, "keccak", mesh=mesh)
    got = launches_since(before)["keccak_rows"]
    if not np.array_equal(tree.cap_u64(), want):
        raise AssertionError("keccak tree over cuda:0 x 2 != single tree")
    if got != sum(tree_launches(rows, MESH_CAP_HEIGHT, 2)):
        raise AssertionError(f"keccak tree over cuda:0 x 2: {got} launches")
    ms = cuda_ms(lambda: build_commitment_tree(
        leaves, MESH_CAP_HEIGHT, "keccak", mesh=mesh), reps=3)
    log(f"keccak tree {cols} x 2^{rows.bit_length() - 1} over cuda:0 x 2: "
        f"cap == single-device cap; {ms:.3f} ms beside the single tree's "
        f"{single_ms:.3f} ms; one call launches {got} [{smi}]")


def check_split(k: int, tables: int, n: int) -> dict:
    """The block counts of a chain proof over a k-entry mesh: aux ran k
    blocks a table of n/k rows, the quotient and G k blocks a table of
    m/k coset points, and the first fold of each table's FRI k blocks of
    m/k; returns each stage's {entries a block: blocks}."""
    m = 2 * n                                   # rate_bits 1
    want = {"aux": n // k, "quotient": m // k, "G": m // k}
    for stage, entries in want.items():
        if block_runs(stage) != {entries: k * tables}:
            raise AssertionError(f"{stage} over {k} entries ran blocks "
                                 f"{block_runs(stage)}, want "
                                 f"{{{entries}: {k * tables}}}")
    if block_runs("fold").get(m // k) != k * tables:
        raise AssertionError(f"the first folds over {k} entries: "
                             f"{block_runs('fold')}")
    return {stage: block_runs(stage)
            for stage in ("aux", "quotient", "openings", "G", "fold")}


def phase_mesh_chain(dev, smi: str, chain_launches: dict, chain_sha: str,
                     chain_stages: dict) -> None:
    """The 2^20-row chain of path 3 proved again: its three trace
    commitments on three CUDA streams at once (`parallel_commits`), and
    over meshes of two and four entries of cuda:0 (and of every card, on
    a host with more than one), where every commitment and the stages
    between them run over the mesh's row blocks. Every proof is path 3's
    byte for byte; the parallel run launches exactly what path 3
    launched; each mesh run's block counts show the split stages."""
    traces, starks, ctls, _ = chain_inputs(CHAIN_WORDS)
    tables = sum(t is not None for t in traces)
    cfg = StarkConfig.standard_fast_config()
    runs = {"parallel_commits": dict(device=dev, parallel_commits=True)}
    for k in MESH_CHAIN_SIZES:
        runs[f"mesh cuda:0 x {k}"] = dict(mesh=Mesh([dev] * k))
    cards = torch.cuda.device_count()
    if cards > 1 and cards & (cards - 1) == 0:
        runs[f"mesh of {cards} cards"] = dict(mesh=make_mesh(cards))
    log(f"memory chain 2^{CHAIN_LOG_ROWS}, path 3 stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in chain_stages.items()))
    for name, kw in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_block_runs()
        before = read_counts()
        tree = TimingTree(f"prove memory chain, {name}")
        with tree:
            proof = prove_all(starks, traces, ctls, cfg, **kw)
        got = launches_since(before)
        if proof_sha256(proof) != chain_sha:
            raise AssertionError(f"memory chain, {name}: proof != path 3's")
        check_launches(got, "poseidon", f"the memory chain, {name}")
        if name == "parallel_commits" and got != chain_launches:
            raise AssertionError(f"launches under parallel_commits {got} != "
                                 f"the sequential run's {chain_launches}")
        split = {}
        if "mesh" in kw:
            split = check_split(len(kw["mesh"]), tables,
                                1 << CHAIN_LOG_ROWS)
        log(f"memory chain 2^{CHAIN_LOG_ROWS} standard config, {name}: "
            f"proof == path 3's [{smi}]:")
        print_tree(tree)
        stages = stage_seconds(tree)
        log(f"  {tree.root.elapsed:9.3f} s  total; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {got}")
        log(f"  stage seconds ({name} / path 3): "
            + ", ".join(f"{k} {stages[k]:.3f} / {chain_stages[k]:.3f}"
                        for k in STAGES)
            + (f"; blocks run {{entries: blocks}} {split}"
               if split else ""))


def phase_mesh_entry(dev) -> None:
    fn, args = entry()
    cap = fn(*args)
    if cap.device.type != "cuda":
        raise AssertionError(f"entry() ran on {cap.device}")
    sha = hashlib.sha256(np.ascontiguousarray(
        GF(cap).to_u64(), dtype="<u8").tobytes()).hexdigest()
    if sha != ENTRY_CAP_SHA256:
        raise AssertionError("entry() cap != the JAX package's")
    log(f"entry() on {cap.device}: cap {tuple(cap.shape)} == the JAX "
        f"package's")
    # make_mesh raises on a host with one card: the mesh that names it
    # twice is passed on purpose
    mesh = make_mesh(2) if torch.cuda.device_count() >= 2 \
        else Mesh([dev] * 2)
    dryrun_multichip(2, device_type="cuda", mesh=mesh)


def phase_mesh_rpc() -> None:
    """The native fetcher through HttpTransport against a JSON-RPC node
    on 127.0.0.1 serving the toy block."""
    node, facts = toy_native_block()
    server, url = serve_loopback(node)
    try:
        t0 = time.perf_counter()
        obj = native_block_prover_input(
            CachedProvider(HttpTransport(url, timeout=60)), 1,
            checkpoint_block_number=0)
        seconds = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
    sha = hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()
    if sha != NATIVE_TOY_SHA256:
        raise AssertionError("native fetch over HTTP != the JAX package's")
    bpi = parse_block_prover_input(obj)
    if bpi.trie_roots_before().state_root != facts["root"]:
        raise AssertionError("decoded state root != the node's")
    storage = bpi.pre_state.storage[native.keccak256(facts["sender"])]
    if storage.root_hash() != facts["storage_root"]:
        raise AssertionError("decoded storage root != the node's")
    log(f"rpc: native_block_prover_input over HTTP from {url} in "
        f"{seconds:.2f} s ({len(node.requests)} requests): == the JAX "
        f"package's object; state and storage roots == the node's")


def phase_mesh(rng, dev, smi: str, chain_launches: dict,
               chain_sha: str, chain_stages: dict) -> dict:
    """Path 10, one proof over several devices; returns its launches."""
    torch.cuda.synchronize()
    zero_counts()
    phase_mesh_caps(rng, dev, smi)
    phase_mesh_keccak(rng, dev, smi)
    phase_mesh_chain(dev, smi, chain_launches, chain_sha, chain_stages)
    phase_mesh_entry(dev)
    phase_mesh_rpc()
    launches = read_counts()
    for name in ("poseidon_permute", "poseidon_sponge", "keccak_rows"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel never launched in path 10")
    return launches


def assembled(program: dict, source: str):
    """`program` assembled by the port; its code hash must be the pinned
    one."""
    constants, opcodes, _ = assembler.load_tables()
    kernel = assembler.assemble([asm_parser.parse(source)], constants,
                                opcodes, optimize=program["optimize"])
    if kernel.code_hash.hex() != program["code_hash"]:
        raise AssertionError(f"{program['entry']}: code hash "
                             f"{kernel.code_hash.hex()} != the JAX "
                             f"assembler's {program['code_hash']}")
    return kernel


def run_program(kernel, entry: str) -> Interpreter:
    """Interpret a program from `entry`; it must end with an empty stack at
    HALT."""
    interp = Interpreter(kernel, initial_offset=kernel.global_labels[entry])
    interp.run()
    if interp.stack() or interp.registers.program_counter != HALT:
        raise AssertionError(f"{entry}: stopped at pc "
                             f"{interp.registers.program_counter:#x} with "
                             f"stack {interp.stack()}")
    return interp


def lsp_frames(messages: list) -> bytes:
    out = b""
    for m in messages:
        body = json.dumps(m).encode()
        out += f"Content-Length: {len(body)}\r\n\r\n".encode() + body
    return out


def lsp_replies(raw: bytes) -> list:
    replies = []
    while raw:
        head, _, rest = raw.partition(b"\r\n\r\n")
        length = int(head.split(b":")[1])
        replies.append(json.loads(rest[:length]))
        raw = rest[length:]
    return replies


def phase_assembled(dev, smi: str) -> dict:
    """Path 11, programs assembled by the port; returns the loop table's
    proof's launches."""
    programs = json.loads(ASM_PROGRAMS.read_text())
    native.require()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rows = {}
    for p in programs["cpu_programs"]:
        interp = run_program(assembled(p, p["source"]), p["entry"])
        rows[p["entry"]] = cpu.cpu_rows_from_run(interp)
    loop = programs["loop"]
    kernel = assembled(loop, loop["source"].replace(
        "ITERATIONS", str(loop["iterations"])))
    interp = run_program(kernel, loop["entry"])
    steps = interp._nvm.trace_len()
    trace, stark = cpu.cpu_rows_from_run(interp)
    t1 = time.perf_counter()
    if steps != loop["steps"] or trace.shape != (cc.NUM_CPU_COLUMNS, 1 << 16):
        raise AssertionError(f"loop: {steps} steps, table {trace.shape}")
    log(f"assembled programs: {len(rows)} snippets of test_cpu.py and the "
        f"loop (n = {loop['iterations']}, optimize=True, {len(kernel.code)} "
        f"code bytes) assembled with the JAX assembler's code hashes, "
        f"interpreted to an empty stack at {HALT:#x} and their CPU rows "
        f"built in {t1 - t0:.2f} s; the loop ran {steps} steps, table "
        f"{trace.shape[0]} x 2^16")

    cfg = StarkConfig(security_bits=1, fri_config=FriConfig(**ASM_TEST_CFG_KW))
    t0 = time.perf_counter()
    small_trace, small_stark = rows["stack_test"]
    small = prove_stark(small_stark, small_trace, cfg, Challenger(),
                        device=dev)
    digest = proof_sha256(small)
    if digest != programs["stack_test_proof_sha256"]:
        raise AssertionError(f"stack_test CPU-table proof sha256 {digest} "
                             f"!= the JAX package's")
    log(f"stack_test CPU table (85 x 16) proved on the card at the test "
        f"config in {time.perf_counter() - t0:.2f} s: proof_to_json sha256 "
        f"== the JAX package's {digest[:8]}…")

    std = StarkConfig.standard_fast_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = read_counts()
    tree = TimingTree("prove CpuStark 2^16 (the loop)")
    with tree:
        proof = prove_stark(stark, trace, std, Challenger(), device=dev)
    launches = launches_since(before)
    check_launches(launches, "poseidon", "the loop's CPU-table proof")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"loop CPU table 85 x 2^16 at the standard config, "
        f"{len(proof.fri_proof.query_rounds)} queries, pow witness "
        f"{proof.fri_proof.pow_witness} [{smi}]:")
    print_tree(tree)
    t0 = time.perf_counter()
    verify_stark(stark, proof, std, Challenger())
    verify_s = time.perf_counter() - t0
    bad = copy.deepcopy(proof)
    change_opening(bad, 0)
    reject_s = expect_rejection("the loop proof with a changed FRI opening",
                                lambda: verify_stark(stark, bad, std,
                                                     Challenger()))
    log(f"  {tree.root.elapsed:9.3f} s  total; peak device memory "
        f"{peak:.2f} GiB; verified by the port's verifier in "
        f"{verify_s:.2f} s; a changed FRI opening rejected in "
        f"{reject_s:.2f} s; launches {launches}")

    with tempfile.TemporaryDirectory() as cache:
        loaded = persistence.load_kernel(persistence.save_kernel(cache,
                                                                 kernel))
    got = run_kernel(loaded, loop["routine"],
                     [HALT, loop["iterations"]]).stack()
    if got != [loop["sum"]]:
        raise AssertionError(f"run_kernel of the cached loop kernel: {got}")
    session = programs["lsp"]
    env = {k: v for k, v in os.environ.items() if k != "ZK_EVM_REFERENCE"}
    out = subprocess.run([sys.executable, "-m", "zk_evm_tpu_torch", "lsp"],
                         input=lsp_frames(session["messages"]),
                         capture_output=True, cwd=REPO, env=env, timeout=120,
                         check=True)
    if lsp_replies(out.stdout) != session["replies"]:
        raise AssertionError(f"lsp replies {out.stdout[:400]!r} != the "
                             f"pinned ones")
    log(f"kernel cache: the loop kernel saved and loaded, run_kernel("
        f"{loop['routine']}, n = {loop['iterations']}) == {loop['sum']}; "
        f"`python -m zk_evm_tpu_torch lsp` answered initialize, "
        f"semanticTokens/full, definition, hover and shutdown as pinned")
    phase = read_counts()
    for name in ("poseidon_permute", "poseidon_sponge"):
        if phase[name] <= 0:
            raise AssertionError(f"{name} kernel never launched in path 11")
    return launches


ROW_SHAPES = {
    "keccak_rows": (2 << LOGIC_LOG_ROWS, logic.NUM_COLUMNS),
    "poseidon_permute": (PERMUTE_BATCHES[-1],),
    "poseidon_sponge": (KECCAK_COLUMNS, 2 << KECCAK_LOG_ROWS),
    "poseidon_pallas_permute": (PERMUTE_BATCHES[-1],),
    "poseidon_pallas_sponge": (COMMIT_POLYS, 2 << COMMIT_LOG_ROWS),
}


class PhaseClock:
    """Wall seconds of each phase of the run, for the closing summary."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def __call__(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = self.seconds.get(name, 0.0) \
            + time.perf_counter() - t0
        return out

    def summary(self) -> str:
        return ("phase seconds: " + ", ".join(
            f"{name} {s:.2f}" for name, s in self.seconds.items())
            + f"; run {time.perf_counter() - self.t0:.2f} s")


def main() -> None:
    clock_of = PhaseClock()
    smi = phase_environment()
    clock = sm_clock_mhz()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(SEED)
    logic_traces = {hasher: logic_trace(rng, LOGIC_CHECK_LOG_ROWS)
                    for hasher in ("poseidon", "keccak")}
    pool, cpu_refs = start_cpu_references(logic_traces)
    try:                                      # checks, beside the references
        clock_of("build", phase_build)
        errs = {**clock_of("permute", phase_permute, rng, dev),
                **clock_of("sponge", phase_sponge, rng, dev)}
        times = clock_of("kernel times", phase_kernel_times, rng, dev, smi,
                         clock)
        keccak_err, keccak_times = clock_of("keccak", phase_keccak, rng,
                                            dev, smi, clock)
        clock_of("logic small", phase_logic_small, logic_traces["poseidon"],
                 cpu_refs["logic poseidon"], dev)
        clock_of("chain small", phase_chain_small, cpu_refs["chain"], dev)
        clock_of("logic small", phase_logic_small, logic_traces["keccak"],
                 cpu_refs["logic keccak"], dev, "keccak")
        clock_of("cdk", phase_cdk, cpu_refs["cdk"], dev, smi)
    finally:
        pool.shutdown(cancel_futures=True)
    # the timed paths, with nothing of this script beside them
    clock_of("commit", phase_commit, rng, dev, smi)
    clock_of("logic", phase_logic_full, rng, dev, smi)
    bench_launches = clock_of("bench", phase_bench, smi)
    chain_launches, chain_sha, chain_stages = clock_of(
        "chain", phase_chain_full, dev, smi)
    clock_of("logic", phase_logic_full, rng, dev, smi, "keccak")
    keccak_launches, _, _ = clock_of("chain", phase_chain_full, dev, smi,
                                     "keccak")
    block_launches = clock_of("block", phase_block, dev, smi)
    witness_launches = clock_of("witness", phase_witness, smi)
    service_launches = clock_of("service", phase_service, smi)
    clock_of("wrap small", phase_wrap_small, dev)
    wrap_launches, chain_wrap = clock_of("wrap", phase_wrap, dev, smi)
    block_wrap_launches, block_wrap = clock_of("block wrap",
                                               phase_block_wrap, dev, smi)
    two_to_one_launches = clock_of("two-to-one", phase_two_to_one, dev,
                                   smi, block_wrap, chain_wrap)
    del chain_wrap, block_wrap
    mesh_launches = clock_of("mesh", phase_mesh, rng, dev, smi,
                             chain_launches, chain_sha, chain_stages)
    assembled_launches = clock_of("assembled", phase_assembled, dev, smi)
    b1033_launches = clock_of("b1033 wrap", phase_b1033_wrap, dev, smi)
    log(clock_of.summary())
    log(f"dense launches: simple-transfer block {block_launches}, chain "
        f"wrap {wrap_launches}, block wrap {block_wrap_launches}, "
        f"two-to-one {two_to_one_launches}, witness chain "
        f"{witness_launches}, service {service_launches}, assembled "
        f"loop's CPU table {assembled_launches}, b1033 wrap (chunks "
        f"{list(B1033_PROVED_CHUNKS)}) {b1033_launches}")
    log(f"keccak launches: memory chain under hasher keccak "
        f"{keccak_launches}")
    log(f"path 10 (one proof over several devices) launches: "
        f"{mesh_launches}")
    times.update({("keccak_rows", shape): row
                  for shape, row in keccak_times.items()})
    errs["keccak_rows"] = keccak_err
    kernels = []
    for name, (source, replaces, _, _, _) in KERNELS.items():
        shape = ROW_SHAPES[name]
        ms, plain_ms, bound_ms, bound_by = times[(name, shape)]
        launches = bench_launches[name] if "pallas" in name \
            else keccak_launches[name] if name == "keccak_rows" \
            else service_launches[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None,
                        "shape": list(shape),
                        "mesh_launches": mesh_launches[name]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["b1033-wrap"]:
        b1033_full_wrap()
    elif sys.argv[1:]:
        raise SystemExit("usage: python3 chip_smoke.py [b1033-wrap]")
    else:
        main()

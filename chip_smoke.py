"""Chip smoke test of the PyTorch/CUDA port (repro_torch) on one H100.

    python3 chip_smoke.py

Phases, each of which must pass for the script to exit 0:
  1. build   - compile the CUDA kernels from src/repro_torch/kernels/csrc,
               one nvcc per source, all started together;
  2. kernels - hold each kernel against its plain PyTorch version on the
               card at the paths' shapes and time it beside its bound and a
               library yardstick: attention (bf16 and int8 caches) within a
               max abs error of 2e-3, inside the 2e-2 bf16 ceiling, and the
               same row bit for bit at B=1 and B=6; the SSD scan within the
               JAX package's SSD tolerances (y in bf16 4e-2, the f32 state
               3e-3, relative and absolute), and its refusal of a P the
               kernel does not slice; since the hybrid family, attention at
               G = 1 (32 query heads on 32 KV heads of 64) and the scan at
               64 heads of 64 with state 64 (zamba2-1.2b); since the moe
               family, attention at G = 3 (24 on 8, granite-moe-3b-a800m)
               and G = 8 (32 on 4, qwen3-moe-30b-a3b), head_dim 64; since
               the last dense configs, head_dim 96 (phi3-mini-3.8b, 32 on
               32), G = 48 (granite-34b, 48 query heads on 1 KV head, a
               query's rows straddling two tiles), qwen1.5-32b's 40 on 40
               and llava-next-mistral-7b's 775-row prefill behind its 576
               patches, each within 2e-3 and, at D = 96 and G = 48, the
               same row bit for bit at B=1 and B=6; since the encdec
               family, whisper-tiny's 6 heads on 6 of 64: the decoder's
               causal prefill (63 rows) and paged step and window (B 6, Sq
               1 and 5, a 7-row pool), and the non-causal case
               (causal=False): the encoder (1500 rows over 1500 fresh
               frames, B 1 and 6), cross-attention at prefill (63 rows over
               the stacked cross leaves) and at verify (the paged entry,
               Sq 1 and 5, B 6), each within 2e-3, rows bit for bit alone
               and in a batch of 6 (causal, non-causal, and at the
               encoder's 1500 rows), and the causal result at the
               encoder's shape far from the non-causal one (a flag the
               kernel ignored would pass neither); since training, the
               attention backward's three kernels (attn_bwd_delta,
               attn_bwd_dkdv, attn_bwd_dq) on the LSE the forward kernel
               keeps (verify_attention_packed(return_lse=True), its output
               the same bits as without it) at qwen2-1.5b's training rows,
               whisper-tiny's encoder, decoder and cross-attention and small
               rows at G 3, 4, 8, 48 and D 16, 96 (and the tiling's ragged
               edges: G 6 at D 128 over 200 positions, D 96 at Sq 100): dQ,
               dK, dV within GRAD_TIGHT of the plain attention's autograd
               gradient, LSE and Delta within STATS_TIGHT, two calls and an
               entry alone bit for bit, a causal limit one position late
               outside the bound; the three kernels' graph ms summed beside
               SDPA's whole backward, and the forward's with and without the
               LSE beside SDPA's forward at the three training shapes; the
               registers and spill bytes of the backward kernels from nvcc's
               report; since ssm and hybrid training, the SSD scan's
               backward (ssd_scan_bwd: a reverse pass with more than one
               chunk, a chunk pass that forms its Gram blocks itself, and a
               reduction) on the chunk start states the forward keeps
               (ssd_scan(return_states=True), its y and state the same bits
               as without them, the states against the plain scan's) at the
               six SSD cases with a start state and both cotangents, at
               mamba2-370m's and zamba2-1.2b's training rows and at two
               more widths (P 48: odd k slices; N 256: state strips):
               dx, ddt, dA, dB, dC and dh0 within SSD_GRAD_TIGHT of
               the plain backward, two calls bit for bit, an
               exclusive-cumsum control outside the bound; since serving
               across a mesh, the attention kernel's shard form
               (verify_attention_packed_shard: one sequence shard of the
               cache at a pos_offset, f32 output and LSE) at SHARD_CASES:
               granite-34b's 48 query heads on 1 KV head of 128 over a
               2048-position shard (a verify wholly past it, the straddling
               first verify against both shards, a shard that sees nothing,
               the 2045-row prefill) and qwen2-1.5b's training rows over the
               two halves of their sequence: the output within
               KERNEL_TIGHT, the LSE within STATS_TIGHT, -inf and output 0
               exactly where a row sees nothing; the library yardstick the
               efficient SDPA kernel with an additive mask and its LSE;
  3. serve   - fleets of 6 devices through repro_torch.api.System's
               engine backend, each greedy one checked against the port's
               reference backend on the same bundle and prompts (the same
               tokens, or a divergence only at a near tie):
               bf16   - full-width qwen2-1.5b (28-layer target, 1-layer
                        draft) on a bf16 pool, the paged and dense bf16
                        kernels;
               int8   - the same model on an int8 pool (the int8 kernels),
                        with the pool's bytes per slot against bf16's;
               dense gather - the bf16 fleet with paged_attention=False:
                        the verify gathers and scatters pool rows, the dense
                        kernel runs every attention call, the paged one none;
               sample - the same model sampled (greedy=False, temperature
                        1), after the sampler phase: speculative_verify at
                        B = 8192 copies of one real verify position, its
                        acceptance within 4 sigma of the analytic count and
                        the first committed tokens' chi-square against the
                        target under the 0.999 quantile (check_sampler);
                        every logit finite, every token in the vocabulary;
               bits8  - the target weight-quantized to 8 bits and
                        dequantized on the card (quant_error and
                        quantized_bytes printed);
               fleet  - two device classes of 3 (k 4 / c_th 0.3 / 1-layer
                        draft; k 2 / c_th 0.5 / 2-layer draft), each class
                        checked against its own reference;
               ssm    - full-width mamba2-370m (48-layer target, 1-layer
                        draft): prefill through the SSD scan kernel, verify
                        by gather/scatter with state checkpoints;
               hybrid - full-width zamba2-1.2b (38 SSD layers and 6
                        applications of the weight-tied attention block; the
                        draft its first 6 SSD layers, one application): the
                        SSD scan in every prefill, the dense attention kernel
                        in prefills, gathered verifies and draft steps;
                        checked as mamba2 is;
               cluster, cluster int8 - 8 devices on the cluster backend, 2
                        in-process replicas x 4 slots (bf16, int8 pools),
                        round-robin; even ids stop after 8 tokens, odd after
                        32, so retirement migrates streams (>= 1 required);
               transport - the transport backend, loopback to one replica,
                        6 devices, pipelined, after System.warmup();
               transport fleet - the fleet on the transport backend: 2
                        replicas, class-affinity, simulated lossless WLAN,
                        draft rates emulated (x10), adaptive k and c_th;
                        each class on its home replica, no round above its
                        k, each class against its own reference;
                        on these lossless links no timeout, fallback round
                        or dropped frame; wire bytes and frames printed;
               remote - the cluster phase's 8 sessions on 2 worker
                        processes (this script in worker mode, below) behind
                        a Router of RemoteReplicas: streams equal to the
                        cluster phase's up to near ties, >= 1 migration
                        across processes, the paged bf16 kernel launched in
                        each worker; control-channel bytes and frames, each
                        worker's peak memory and times printed;
               remote spawned - System.build of
                        examples/specs/cluster_remote.json (its model
                        swapped for reduced mamba2-370m, see
                        serve_remote_spawned) spawning and placing 2 workers
                        on the cluster and transport backends: each serve
                        equal to the in-process cluster, no worker process
                        or socket directory left after close();
               remote chaos - the remote phase's setup under a respawn and
                        recovery FaultPolicy, worker 1 SIGKILLed at Router
                        step CHAOS_KILL_STEP (it then holds >= 2 streams
                        with committed tokens) and revived through a
                        channel_factory that starts a fresh worker: 1
                        eviction, 1 respawn, nothing shed, every stream of
                        worker 1 recovered by device replay, streams equal
                        to the in-process cluster phase's up to near ties,
                        the revived worker launching the dense and paged
                        bf16 kernels; respawn and recovery seconds, tokens
                        replayed, the flight dump and tokens/s printed;
               chaos spawned - examples/specs/chaos.json (its own reduced
                        qwen2, head_dim 16) on 2 spawned workers, four runs
                        each held to its fault-free in-process serve: the
                        spec's kill with respawn and recovery; a hang found
                        by heartbeat or RPC timeout, evicted and revived
                        (time to eviction printed); a flap absorbed by
                        retried RPCs (through repro_torch.launch.chaos
                        --check); the kill under the default policy, whose
                        lost sessions end shed;
               moe    - full-width granite-moe-3b-a800m as registered (32
                        layers, 40 experts, top-8, capacity factor 1.25;
                        the draft its layer 0), served twice: every logit
                        finite and the second serve's tokens the first's
                        (acceptance printed, not required).
                        The capacity dispatch drops assignments past an
                        expert's capacity, so a stream depends on the rows
                        batched with it and the engine (a slot prefilled
                        alone, the ready rows padded to a bucket) cannot
                        equal the reference (6 devices in one batch); the
                        moe tally (dropped/assigned for prefills, verifies
                        and draft steps) is printed. The dropless twin (the
                        same weights, capacity factor E/K) is held to the
                        reference as the paper pair is, with nothing
                        dropped in either serve;
               paper  - the paper's pair at its published widths
                        (llama-11b-target, 40 layers, 32 query heads on 8
                        KV heads of 128, an untied head, verifying
                        llama-1b-draft, each with its own seeded init): both
                        bf16 kernels launched; acceptance printed, not
                        required (two random models of different widths
                        essentially never agree); held to the reference
                        with the replay witness as mamba2 is (see check());
               every kernel of a path must be launched in its run (counters
               reset just before, read just after; "launches" is a kernel's
               main path's count, "launches_by_path" every path's), some
               drafts accepted (for mamba2 some rejected too, so rollback
               runs). A divergence from the reference passes only at a near
               tie; for mamba2 also where a target-only replay on each
               stream's own commit boundaries and batch shapes gives back
               both streams (see check()).
  4. calibrate h100 - the 11B verify step per bucket (1, 2, 4, 8; median
               of 5 after a warm one) beside its weight-stream bound, which
               it must not beat, and the h100 ServerProfile's prediction;
               prints the profile's launch overhead as measured here;
  5. moe 30b - full-width qwen3-moe-30b-a3b (48 layers, 128 experts,
               top-8; 60.2 GB of bf16 weights, its 1-layer draft sharing the
               target's tensors) on a card emptied of the earlier bundles:
               served and checked as granite-moe is (16 new tokens), then
               its verify step per bucket (1, 2, 4, 8) beside the bound of
               every weight, which the capacity dispatch reads on every
               call and which the step must not beat, and the bound of
               one token's active parameters;
  6. vlm     - full-width llava-next-mistral-7b (32 layers of 4096, 32
               query heads on 8 KV heads of 128, untied; the draft its
               layer 0) served as its backbone, as the JAX System serves
               it (serve vlm), held to the reference with the replay
               witness (check vlm); then 2 prompts of 199 tokens behind
               576 stub patch embeddings through the dense kernel (prefix
               vlm: finite logits, length 775; a prefill of 770 rows, a
               decode of the last 5 tokens and their commit give the
               whole prefill's K/V at positions 0..769 bit for bit, layer
               0's K/V at 770..774 within 2e-2, where a decode one
               position late lands far outside, and for the draft the
               whole prefill's last logits within LOGIT_TOL);
  7. dense configs - phi3-mini-3.8b (head_dim 96, 32 new tokens),
               granite-34b (88 layers of 6144, the gelu MLP, 48 query
               heads on 1 KV head; 16) and qwen1.5-32b at a depth cut of
               48 of its 64 layers (16; its 64 layers do not fit on one
               card beside the draft, the f32 heads and the pool), each at
               its published widths, its bundle's parameters, bytes and
               device memory printed after init, served and checked as
               vlm is, both bf16 kernels launched;
  8. encdec  - full-width whisper-tiny (4 decoder and 4 encoder layers of
               384, 6 heads of 64, vocab 51865, untied; 1500 stub frames;
               a decoder position table of 448 rows, whisper's text
               context), 6 streams of prompt 64: each prefilled alone
               through make_prefill_step(with_frontend=True) into a
               PagedKVCache of 7 rows (after the decode each slot's cross
               leaves a fresh prefill's bit for bit, a batched prefill's
               within 2e-3), then 32
               greedy tokens one a step through the slot-indexed forward
               (Sq 1), then the same streams teacher-forced in windows of
               K+1 = 5 through make_paged_verify_step: every argmax the
               one-a-step token, or a near tie (top-2 gap under LOGIT_TOL,
               printed); the dense, paged and both non-causal entries
               launched (4 encoder and 4 cross calls a prefill, 4 cross
               calls a step); seconds, bytes per slot, peak memory;
  9. checkpoint - the full-width whisper-tiny params saved with
               repro_torch.checkpoint (the JAX package's format) from the
               card and restored onto it, every tensor bit-equal; bytes
               and seconds each way;
  (train whisper runs after phase 2, on a card no serve bundle has used,
  the train phases of this process after phase 14:)
  10. train qwen2 - full-width qwen2-1.5b trained 8 steps through
               repro_torch.training (B 8, S 128, remat, chunks of 64): step
               1's gradients with the backward kernels within GRAD_LEAF_TOL
               of the same step with the plain attention, and a control
               (the plain backward one position late) beyond it; the losses finite
               and falling; each backward kernel launched 28 x 8 times;
               seconds a step, tokens/s and peak memory printed;
      train mamba2, train zamba2 - full-width mamba2-370m and
               zamba2-1.2b trained 8 steps the same way: step 1's
               gradients with the SSD kernels within GRAD_LEAF_TOL of the
               same step with the plain scan, a control (the kernel's
               forward, the plain backward on dy one step late) beyond it;
               the scan kernel launched twice a layer and step (remat), its
               backward once; for zamba2 also the attention kernels of the
               shared block's 6 applications a step (the forward twice);
  11. train whisper - python -m repro_torch.launch.train --arch whisper-tiny
               at full width (1500 stub frames, B 8, S 128): 6 steps
               straight, then --fail-at 3 --ckpt-every 2 (a non-zero exit)
               and a rerun that resumes at step 3; the step-6 checkpoints
               (params and optimizer state) and the last losses bit-equal;
               each run's launches of the backward kernels (12 a step) and
               of the forward entries (8 causal, 12 non-causal a step);
  mesh     - (after phase 9) serving across a device mesh: four ranks of
               this script (--mesh-rank) on the card over gloo, a (2, 2)
               mesh of data x model (launch.mesh.make_debug_mesh), each
               holding only its pieces (sharding.policy): granite-34b at
               full width cut to 16 of its 88 layers (its cache of 4096
               positions sequence-sharded, 2048 a model rank; B 4, a
               2046-token prompt, so the first verify's 5 rows straddle
               the shards; 8 verify rounds through
               verification.make_verify_step(ctx=)) and granite-moe-3b-
               a800m's dropless twin at full width and depth (KV heads and
               experts split, 20 a rank; prompt 200, 8 rounds), each held
               to the same weights on one rank in this process: greedy
               tokens and commits equal but at a near tie (gaps printed),
               the prefill's logits printed against one rank's; the shard
               form launched in every granite layer, the dense kernel on
               the moe run's heads, nothing dropped; each rank's
               parameters, cache piece, peak memory and seconds printed;
  12. sim fig4 - serving.simulator on the h100 profile in the setting of the
               JAX package's benchmarks/wstgr.py --quick (a prediction; its
               12 simulations run in processes of their own from phase 2
               on, beside the device phases);
  13. tune   - repro_torch.tuning.tune of examples/specs/fleet.json on the
               card with the h100 profile, its winner round-tripped through
               JSON and served, the attention kernels launched; then the
               tune CLI once in its own process;
  14. cli    - python -m repro_torch.cli in subprocesses on the card, each
               with a timeout: serve --check of examples/specs/engine.json,
               of a hybrid target from flags and of a hybrid pair from a
               spec (the reference match printed OK), trace with the
               Prometheus exposition (one row per session round), and top
               --demo over two spawned workers (both with rounds in the
               last frame, nothing left after).
``python3 chip_smoke.py --worker --counts FILE --listen ADDR`` is the
worker mode the remote phase starts (see worker_main), ``--mesh-rank R
--mesh-dir DIR --mesh-port PORT`` a rank of the mesh phase
(mesh_rank_main).
The line before the last is a JSON object with one record per kernel entry;
the last line is {"ok": true, "device": {...}}. A kernel's "ms" (and
"library_ms", "plain_ms") is the mean of 50 back-to-back calls from Python,
as the eager serve pays it, host included; "graph_ms" (and
"library_graph_ms", "walk_graph_ms") is device time from a CUDA graph of
56 calls, without the host. The script imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
TF32_FLOPS = 495e12        # H100 SXM dense tf32 tensor-core peak
F32_FLOPS = 67e12          # H100 SXM f32 peak outside the tensor cores
KERNEL_TOL = 2e-2          # the bf16 bound of tests/test_kernels.py
# and a tighter one for these shapes: 4x the largest error the kernels have
# shown here (4.9e-4); a causal limit off by one position moves outputs by
# up to ~1e-2 at kv ~230, which the 2e-2 bound alone would let through
KERNEL_TIGHT = 2e-3
# a greedy divergence between the engine and the reference is a near tie
# where the reference's top-2 logit gap is below this: the two backends batch
# rows differently, so bf16 matmul rounding may differ in the last bit of the
# hidden state, which moves f32 logits by up to ~1e-2 at these widths (see
# check() for mamba2)
LOGIT_TOL = 5e-2
# the SSD scan's limits, those of the JAX package's SSD tests
# (tests/test_kernels.py): |kernel - plain| <= tol * (1 + |plain|). y is
# bf16 (one ulp is 2^-8 relative, and a sum taken in another order can land
# on the other side of a rounding point); the state is f32, where the scan's
# sums over up to 256 steps and 128 state dims in another order (and the
# card's expf) move it by far less. The kernel's f32-operand products run as
# 2xTF32 (~22 significant bits of the f32 operand), C.B^T on exact bf16
# products.
SSD_TOL = {"y": 4e-2, "state": 3e-3}
# calls per CUDA graph when a kernel is timed (two walks of 28 layers)
GRAPH_CALLS = 56
# and a backward kernel (one step's 28 layers)
GRAD_CALLS = 28
# scale of every layer's output projections in the served bundles, chosen so
# that drafts are partly accepted (see full_width_bundle)
RESID_SCALE = 0.5

# each kernel entry: the TPU kernel it replaces (file:line of its
# pallas_call) and its source. The dense int8 entry is the dense kernel's
# int8 load path: the JAX package has no Pallas kernel for a dense int8
# cache, its XLA mirror dequantizes in the chunk loop (layers.py:317). The
# non-causal entries (the encdec family's encoder and cross-attention) are
# the same kernel's causal=False case; the Pallas kernel has only the
# causal-offset mask, so their JAX counterpart is the XLA mirror
# flash_attention with causal=False (layers.py:215).
REPLACES = {
    "verify_attention_packed": "src/repro/kernels/verify_attn.py:184",
    "verify_attention_paged": "src/repro/kernels/verify_attn.py:291",
    "verify_attention_paged_int8": "src/repro/kernels/verify_attn.py:265",
    "verify_attention_packed_int8": "src/repro/kernels/verify_attn.py:184",
    "verify_attention_packed_noncausal": "src/repro/models/layers.py:215",
    "verify_attention_paged_noncausal": "src/repro/models/layers.py:215",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:98",
    # attention's gradient (training): no Pallas kernel has one; JAX
    # autodiffs its XLA mirror
    **{name: "no Pallas counterpart: JAX autodiffs src/repro/models/layers.py:215"
       for name in ("attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")},
    # the SSD scan's gradient (training): no Pallas kernel has one; JAX
    # autodiffs its XLA mirror mamba2.ssd_chunked
    "ssd_scan_bwd": "no Pallas counterpart: JAX autodiffs src/repro/models/mamba2.py:80",
    # the shard form over one sequence shard of the cache: the JAX package
    # runs this kernel's math in its XLA mirror with pos_offset= and
    # return_stats=True inside sp_append_attend (collectives.py:76)
    "verify_attention_packed_shard": "src/repro/kernels/verify_attn.py:184",
}
SOURCES = {
    "verify_attn": "src/repro_torch/kernels/csrc/verify_attn.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "attn_bwd": "src/repro_torch/kernels/csrc/attn_bwd.cu",
}
SOURCE_OF = {name: SOURCES[next((src for src in ("ssd_scan", "attn_bwd") if name.startswith(src)),
                                "verify_attn")]
             for name in REPLACES}
# nvcc's output for each source, kept by build_kernels for the kernels phase
BUILD_LOGS: dict = {}
# the families whose recurrent state rounds to bf16 at every commit (see check())
RECURRENT = ("ssm", "hybrid")
# the kernel entries a qwen2 serve on a bf16 / an int8 pool must launch
BF16_PATH = {"verify_attention_packed": None, "verify_attention_paged": None}
INT8_PATH = {"verify_attention_packed_int8": None, "verify_attention_paged_int8": None}


def _time_ms(fn, iters: int = 50) -> float:
    """Mean time of one call over ``iters`` back-to-back calls from Python, by
    CUDA events: the device time when the device is the slower side, else
    the host time of the call (the plain versions; an eager caller)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(calls, reps: int = 5) -> float:
    """Device time of one call: ``calls`` (a list of thunks) captured into one
    CUDA graph and replayed, so the host's launch cost is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def _bound(q, kv_valid_host, slots_host, skv, hkv, group, kv_elem_bytes=2,
           causal=True, lse=False) -> tuple:
    """Least time for one attention call: the bytes it must move once at the
    HBM rate, or the two products' flops at the bf16 peak, whichever is
    larger. K/V bytes count each distinct cache row once, as far as the
    largest kv_valid any entry gives it (duplicate scratch slots read one
    row), at the cache's element size, plus an int8 row's two f32 scales per
    head; q is read and out written once (and with ``lse`` each row's f32
    LSE written once); kv_valid (and slots, for a paged call) read once.
    The flops count the positions each query row sees: up to its own
    position when causal, all kv_valid of its row when not."""
    B, Sq, Hq, D = q.shape
    rows = slots_host if slots_host is not None else range(B)
    seen_row: dict = {}
    for row, n in zip(rows, kv_valid_host):
        seen_row[row] = max(seen_row.get(row, 0), min(skv, int(n)))
    kv_bytes = sum(seen_row.values()) * hkv * D * kv_elem_bytes * 2
    if kv_elem_bytes == 1:
        kv_bytes += len(seen_row) * hkv * 4 * 2
    io_bytes = 2 * q.numel() * 2 + B * 4 * (1 if slots_host is None else 2)
    if lse:
        io_bytes += B * Sq * Hq * 4
    flops = 0
    for n in kv_valid_host:
        n = min(skv, int(n))
        for i in range(Sq):
            vis = max(0, min(n, n - Sq + i + 1)) if causal else n
            flops += 2 * 2 * vis * D * hkv * group
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ssd_bound(B, S, H, P, N, chunk) -> dict:
    """Least time for one SSD scan: its inputs read and outputs written once
    (x, dt, A, B, C, h0; y, state) at the HBM rate, or its operations at the
    peak of the precision each runs in, whichever is larger. Per (b, chunk of
    q rows): C.B^T over the causal triangle q(q+1)/2*N multiply-adds, once,
    since B and C are shared by every head (bf16 tensor cores). Per (b, h,
    chunk): the carry-in C.h q*P*N, W.x q(q+1)/2*P and the state update
    q*P*N multiply-adds (tf32 tensor cores: the kernel's 2xTF32 runs each
    twice, which the bound does not count), and on the f32 cores the
    carry-in's scale and add (2qP), W's two products per (i, j<=i), B * decay
    (qN) and the state's decay (2PN). Also returns the bound with every
    operation at the f32 peak (``f32_ms``), the count of the first kernel,
    which ran no tensor cores."""
    nbytes = (B * S * H * P * 2 * 2 + B * S * H * 4 + H * 4 + 2 * B * S * N * 2
              + 2 * B * H * P * N * 4)
    Q = min(chunk, S)
    cb = mm = vec = 0
    for t0 in range(0, S, Q):
        q = min(Q, S - t0)
        tri = q * (q + 1) // 2
        cb += B * 2 * tri * N
        mm += B * H * (2 * q * P * N + 2 * tri * P + 2 * q * P * N)
        vec += B * H * (2 * q * P + 2 * tri + q * N + 2 * P * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (cb / BF16_FLOPS + mm / TF32_FLOPS + vec / F32_FLOPS) * 1e3
    t_f32 = max(t_bytes, (cb + mm + vec) / F32_FLOPS * 1e3)
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes", "f32_ms": t_f32}
    return {"bound_ms": t_ops, "bound_by": "operations", "f32_ms": t_f32}


def _sdpa_inputs(q, k, v, kv_valid, causal=True):
    """Arguments of one scaled_dot_product_attention call computing the same
    attention over the same rows (a yardstick only; the port never calls
    it): heads first, K/V heads repeated to the query heads, boolean mask."""
    B, Sq, Hq, D = q.shape
    G = Hq // k.shape[2]
    Skv = k.shape[1]
    if causal:
        qpos = kv_valid[:, None].long() - Sq + torch.arange(Sq, device=q.device)[None]
    else:
        qpos = (kv_valid[:, None].long() - 1).expand(B, Sq)
    mask = torch.arange(Skv, device=q.device)[None, None, :] <= qpos[:, :, None]
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    return q.transpose(1, 2).contiguous(), kh, vh, mask[:, None]


def _quantize(x):
    """An int8 stacked cache (L, rows, S, Hkv, D) with per-(layer, row,
    head) symmetric scales, as the model's append makes them."""
    scale = x.float().abs().amax(dim=(2, 4)) / 127.0 + 1e-6
    q = torch.clamp(torch.round(x.float() / scale[:, :, None, :, None]), -127, 127)
    return q.to(torch.int8), scale


def _record(records, name, idx, main_idx, line) -> None:
    rec = records[name]
    rec["max_abs_err"] = max(rec["max_abs_err"], line["max_abs_err"])
    if idx == main_idx:
        rec.update({k: v for k, v in line.items() if k not in ("case", "name", "max_abs_err")})
    print("kernel", json.dumps(line), flush=True)


# whisper-tiny's 1500 encoder frames and 4 decoder layers; the encdec
# phase's prompt (63 rows prefilled, the last token fed to the first step),
# its 6 streams and its window of K+1
ENCDEC_F, ENCDEC_L = 1500, 4
ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_K, ENCDEC_STREAMS = 64, 32, 4, 6


def check_attention(records: dict) -> None:
    """Every attention entry against its plain version at the paths' shapes."""
    from repro_torch.kernels import ref, verify_attn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    # whisper-tiny's non-causal records: the encoder at B 1 (what each
    # prefill runs) and cross-attention at verify Sq 1 (what each step runs)
    encoder = ("bf16", 1, ENCDEC_F, 6, 6, 64, ENCDEC_F, [ENCDEC_F], None, 0, False)
    cross_step = ("bf16", 6, 1, 6, 6, 64, ENCDEC_F, [ENCDEC_F] * 6, [3, 0, 5, 1, 2, 4], 4, False)
    # (kv, B, Sq, Hq, Hkv, D, Skv, kv_valid, slots, layers[, causal]) - slots
    # None: dense; layers 0: fresh K/V (B, Skv, Hkv, D) and no layer, as the
    # encoder passes them; causal unless a last column says False
    cases = [
        ("bf16", 1, 1, 12, 2, 128, 512, [230], None, 28),     # draft decode
        ("bf16", 6, 5, 12, 2, 128, 512, [205, 212, 233, 240, 219, 208], None, 28),  # reference verify
        ("bf16", 1, 199, 12, 2, 128, 512, [199], None, 2),    # slot prefill
        ("bf16", 3, 5, 12, 2, 128, 200, [200, 120, 77], None, 1),  # ragged Skv
        ("bf16", 2, 5, 2, 2, 128, 96, [96, 40], None, 1),     # G = 1
        ("bf16", 2, 4, 8, 2, 64, 100, [100, 9], None, 1),     # D = 64
        ("bf16", 6, 5, 12, 2, 128, 512, [205, 233, 240, 5, 5, 5], [3, 0, 5, 6, 6, 6], 28),  # verify, scratch dups
        ("bf16", 4, 5, 12, 2, 128, 200, [200, 120, 6, 17], [1, 2, 4, 4], 1),  # ragged Skv, dups
        ("bf16", 3, 5, 2, 2, 128, 96, [96, 40, 5], [0, 2, 2], 1),   # G = 1
        ("int8", 6, 5, 12, 2, 128, 512, [205, 233, 240, 5, 5, 5], [3, 0, 5, 6, 6, 6], 28),  # int8 verify
        ("int8", 1, 199, 12, 2, 128, 512, [199], None, 28),   # int8 slot prefill
        ("int8", 6, 5, 12, 2, 128, 512, [205, 212, 233, 240, 219, 208], None, 28),  # int8 reference verify
        ("int8", 4, 5, 12, 2, 128, 200, [200, 120, 6, 17], [1, 2, 4, 4], 1),  # ragged Skv, dups
        ("int8", 2, 4, 8, 2, 64, 100, [100, 9], None, 1),     # D = 64
        # the kernel's 64-position splits: the last query's position at a
        # split's last position (kv_valid 64, 128) and one past it (65, 129)
        ("bf16", 4, 5, 12, 2, 128, 512, [64, 65, 128, 129], [0, 1, 2, 3], 1),
        ("bf16", 4, 5, 12, 2, 128, 200, [64, 65, 128, 129], None, 1),
        ("int8", 4, 5, 12, 2, 128, 512, [64, 65, 128, 129], [3, 2, 1, 0], 1),
        # kv_valid < Sq: the first queries see no position and give 0
        ("bf16", 2, 5, 12, 2, 128, 64, [3, 5], None, 1),
        ("int8", 3, 5, 12, 2, 128, 200, [2, 130, 4], [2, 0, 1], 1),
        # head_dim 16, the reduced qwen2 of examples/specs/chaos.json (Hq 4,
        # Hkv 2, max_len 128, k_max 4, 2 slots a replica and the scratch
        # row): engine verify, with a scratch row, a replayed force_extend
        # run (B=1), the slot prefill of an 8-token prompt, the draft's
        # decode, two splits
        ("bf16", 2, 5, 4, 2, 16, 128, [21, 30], [0, 1], 2),
        ("bf16", 2, 5, 4, 2, 16, 128, [27, 5], [1, 2], 2),
        ("bf16", 1, 5, 4, 2, 16, 128, [19], [1], 2),
        ("bf16", 1, 8, 4, 2, 16, 128, [8], None, 2),
        ("bf16", 1, 1, 4, 2, 16, 128, [14], None, 1),
        ("bf16", 2, 5, 4, 2, 16, 128, [70, 128], [1, 0], 2),
        ("int8", 2, 5, 4, 2, 16, 128, [21, 30], [0, 1], 2),
        ("int8", 1, 8, 4, 2, 16, 128, [8], None, 2),
        # the paper pair (llama-11b-target verifying llama-1b-draft): 32
        # query heads on 8 KV heads (G = 4); the draft's decode at head_dim
        # 64 over 16 layers, the target's slot prefill and its engine verify
        # (6 streams and 2 scratch rows, bucket 8) at head_dim 128 over 40
        ("bf16", 1, 1, 32, 8, 64, 512, [230], None, 16),
        ("bf16", 1, 199, 32, 8, 128, 512, [199], None, 40),
        ("bf16", 8, 5, 32, 8, 128, 512, [205, 212, 233, 240, 219, 208, 5, 5],
         [3, 0, 5, 1, 2, 4, 6, 6], 40),
        ("bf16", 4, 5, 32, 8, 128, 512, [64, 65, 128, 129], [0, 1, 2, 3], 1),
        # zamba2-1.2b's shared attention block: 32 query heads on 32 KV
        # heads of 64 (G = 1) over a dense cache of one K/V slice per
        # application (6 in the target, 1 in its 6-layer draft): the draft's
        # decode, the target's slot prefill, the gathered verify (B 6)
        ("bf16", 1, 1, 32, 32, 64, 512, [230], None, 1),
        ("bf16", 1, 199, 32, 32, 64, 512, [199], None, 6),
        ("bf16", 6, 5, 32, 32, 64, 512, [205, 212, 233, 240, 219, 208], None, 6),
        ("bf16", 4, 5, 32, 32, 64, 512, [64, 65, 128, 129], None, 6),
        # the moe family at head_dim 64: granite-moe-3b-a800m's 24 query
        # heads on 8 KV heads (G = 3, the first G that is not a power of
        # two; 32 layers) and qwen3-moe-30b-a3b's 32 on 4 (G = 8; 48
        # layers): the draft's decode (its 1 layer), the slot prefill, the
        # engine's paged verify (a bucket of 6: 5 streams and the scratch
        # row), and at G = 3 the int8 paged verify and two splits' edges
        ("bf16", 1, 1, 24, 8, 64, 512, [230], None, 1),
        ("bf16", 1, 199, 24, 8, 64, 512, [199], None, 32),
        ("bf16", 6, 5, 24, 8, 64, 512, [205, 212, 233, 240, 219, 5], [3, 0, 5, 1, 2, 6], 32),
        ("int8", 6, 5, 24, 8, 64, 512, [205, 212, 233, 240, 219, 5], [3, 0, 5, 1, 2, 6], 32),
        ("bf16", 4, 5, 24, 8, 64, 512, [64, 65, 128, 129], [0, 1, 2, 3], 1),
        ("bf16", 1, 1, 32, 4, 64, 512, [230], None, 1),
        ("bf16", 1, 199, 32, 4, 64, 512, [199], None, 48),
        ("bf16", 6, 5, 32, 4, 64, 512, [205, 212, 233, 240, 219, 5], [3, 0, 5, 1, 2, 6], 48),
        # phi3-mini-3.8b: 32 query heads on 32 KV heads of 96 (G = 1, the
        # D = 96 instantiation; 32 layers): the draft's decode, the slot
        # prefill (bf16 and int8), the paged verify (5 streams and the
        # scratch row, bf16 and int8), and the splits' edges, paged and dense
        ("bf16", 1, 1, 32, 32, 96, 512, [230], None, 1),
        ("bf16", 1, 199, 32, 32, 96, 512, [199], None, 32),
        ("int8", 1, 199, 32, 32, 96, 512, [199], None, 32),
        ("bf16", 6, 5, 32, 32, 96, 512, [205, 212, 233, 240, 219, 5], [3, 0, 5, 1, 2, 6], 32),
        ("int8", 6, 5, 32, 32, 96, 512, [205, 212, 233, 240, 219, 5], [3, 0, 5, 1, 2, 6], 32),
        ("bf16", 4, 5, 32, 32, 96, 512, [64, 65, 128, 129], [0, 1, 2, 3], 1),
        ("bf16", 4, 5, 32, 32, 96, 200, [64, 65, 128, 129], None, 1),
        # granite-34b: 48 query heads on 1 KV head of 128 (MQA, G = 48: a
        # query's 48 rows span two 32-row tiles; 88 layers): the same set
        ("bf16", 1, 1, 48, 1, 128, 512, [230], None, 1),
        ("bf16", 1, 199, 48, 1, 128, 512, [199], None, 88),
        ("int8", 1, 199, 48, 1, 128, 512, [199], None, 88),
        ("bf16", 6, 5, 48, 1, 128, 512, [205, 212, 233, 240, 219, 5], [3, 0, 5, 1, 2, 6], 88),
        ("int8", 6, 5, 48, 1, 128, 512, [205, 212, 233, 240, 219, 5], [3, 0, 5, 1, 2, 6], 88),
        ("bf16", 4, 5, 48, 1, 128, 512, [64, 65, 128, 129], [0, 1, 2, 3], 1),
        ("int8", 4, 5, 48, 1, 128, 200, [64, 65, 128, 129], None, 1),
        # qwen1.5-32b: 40 query heads on 40 KV heads of 128 (G = 1) over its
        # 64 layers: the slot prefill and the paged verify
        ("bf16", 1, 199, 40, 40, 128, 512, [199], None, 64),
        ("bf16", 6, 5, 40, 40, 128, 512, [205, 212, 233, 240, 219, 5], [3, 0, 5, 1, 2, 6], 64),
        # llava-next-mistral-7b's prefill behind its 576 stub patches: 775
        # rows, 32 query heads on 8 KV heads of 128 (G = 4; 32 layers), the
        # cache of the prefix vlm phase (800 positions)
        ("bf16", 1, 775, 32, 8, 128, 800, [775], None, 32),
        # whisper-tiny: 6 query heads on 6 KV heads of 64 (G = 1) over its 4
        # decoder layers and the encdec phase's pool (6 streams and the
        # scratch row, max_len 128): the decoder's causal prefill of 63 rows,
        # its one-token step and a verify window with scratch duplicates;
        # then the non-causal case: the encoder over 1500 fresh frames (B 1
        # and 6), cross-attention at prefill (63 rows over layer 3 of the
        # stacked cross leaves) and at verify (paged, Sq 1 and 5), the
        # splits' edges and a kv_valid below Sq
        ("bf16", 1, 63, 6, 6, 64, 128, [63], None, 4),
        ("bf16", 6, 1, 6, 6, 64, 128, [64, 77, 90, 96, 85, 1], [3, 0, 5, 1, 2, 6], 4),
        ("bf16", 6, 5, 6, 6, 64, 128, [68, 81, 100, 5, 5, 5], [3, 0, 5, 6, 6, 6], 4),
        encoder,
        ("bf16", 6, ENCDEC_F, 6, 6, 64, ENCDEC_F, [ENCDEC_F] * 6, None, 0, False),
        # the mesh phase's encoder: a rank's 2 rows on its 3 of the 6 heads
        ("bf16", 2, ENCDEC_F, 3, 3, 64, ENCDEC_F, [ENCDEC_F] * 2, None, 0, False),
        ("bf16", 1, 63, 6, 6, 64, ENCDEC_F, [ENCDEC_F], None, 4, False),
        cross_step,
        ("bf16", 6, 5, 6, 6, 64, ENCDEC_F, [ENCDEC_F] * 6, [3, 0, 5, 1, 2, 4], 4, False),
        ("bf16", 4, 5, 6, 6, 64, 200, [64, 65, 128, 129], [0, 1, 2, 3], 1, False),
        ("bf16", 3, 5, 6, 6, 64, 200, [200, 2, 77], None, 1, False),
    ]
    # the shape each entry is timed at for the record: the draft's one-token
    # decode (most launches of the dense kernel), the engine's verify, the
    # int8 slot prefill
    main_case = {"verify_attention_packed": 0, "verify_attention_paged": 6,
                 "verify_attention_paged_int8": 9, "verify_attention_packed_int8": 10,
                 "verify_attention_packed_noncausal": cases.index(encoder),
                 "verify_attention_paged_noncausal": cases.index(cross_step)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for idx, (kv, B, Sq, Hq, Hkv, D, Skv, kvv, slots, L, *flag) in enumerate(cases):
        causal = flag[0] if flag else True
        n_rows = (max(slots) + 1) if slots is not None else B
        lead = (L,) if L else ()
        k = rnd(*lead, n_rows, Skv, Hkv, D)
        v = rnd(*lead, n_rows, Skv, Hkv, D)
        ks = vs = None
        if kv == "int8":
            (k, ks), (v, vs) = _quantize(k), _quantize(v)
        q = rnd(B, Sq, Hq, D)
        kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
        layer = L - 1 if L else None
        sel = lambda t: t if t is None or layer is None else t[layer]  # noqa: E731
        kc, vc = sel(k), sel(v)
        if slots is None:
            name = "verify_attention_packed"
            rows = torch.arange(B, device=dev)
            kern = lambda li=layer, causal=causal: verify_attn.verify_attention_packed(  # noqa: E731
                q, k, v, kv_valid, layer=li, k_scale=ks, v_scale=vs, causal=causal)
            plain = lambda: ref.verify_attention_ref(  # noqa: E731
                q, kc, vc, kv_valid, k_scale=sel(ks), v_scale=sel(vs), causal=causal)
        else:
            name = "verify_attention_paged"
            sl = torch.tensor(slots, dtype=torch.int32, device=dev)
            rows = sl.long()
            kern = lambda li=layer, causal=causal: verify_attn.verify_attention_paged(  # noqa: E731
                q, k, v, sl, kv_valid, layer=li, k_scale=ks, v_scale=vs, causal=causal)
            plain = lambda: ref.verify_attention_paged_ref(  # noqa: E731
                q, kc, vc, sl, kv_valid, k_scale=sel(ks), v_scale=sel(vs), causal=causal)
        if kv == "int8":
            name += "_int8"
        if not causal:
            name += "_noncausal"
        # the library call gets the scheduled rows already gathered (and
        # an int8 cache already dequantized)
        kl, vl = kc[rows], vc[rows]
        if kv == "int8":
            kl, vl = ref.dequant(kl, sel(ks)[rows]), ref.dequant(vl, sel(vs)[rows])
        lib_args = _sdpa_inputs(q, kl, vl, kv_valid, causal=causal)
        lib = lambda: sdpa(*lib_args[:3], attn_mask=lib_args[3])  # noqa: E731
        out = kern()
        torch.cuda.synchronize()
        err = (out.float() - plain().float()).abs().max().item()
        if not math.isfinite(err) or err > KERNEL_TIGHT:
            raise AssertionError(f"{name} case {idx}: max abs err {err} > {KERNEL_TIGHT} "
                                 f"(ceiling {KERNEL_TOL})")
        bound_ms, bound_by = _bound(q, kvv, slots, Skv, Hkv, Hq // Hkv, k.element_size(),
                                    causal=causal)
        # the encoder's calls take milliseconds: fewer of them
        iters, calls = (10, 8) if Sq * min(Skv, max(kvv)) > 10**6 else (50, GRAPH_CALLS)
        line = {"case": idx, "name": name, "shape": f"B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
                f"Skv={Skv} kv_valid={kvv} slots={slots} layers={L} {kv}"
                f"{'' if causal else ' non-causal'}", "max_abs_err": err,
                "ms": _time_ms(kern, iters), "graph_ms": _graph_ms([kern] * calls),
                "plain_ms": _time_ms(plain, iters), "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": _time_ms(lib, iters), "library_graph_ms": _graph_ms([lib] * calls)}
        if idx == main_case[name] and L:
            # as the layer loop reads the stacked cache: one call per layer
            line["walk_graph_ms"] = _graph_ms([lambda li=li: kern(li) for li in range(L)] * 2)
        if cases[idx] is encoder:
            # the control: the same call with the flag flipped gives far
            # other output, so a flag the kernel ignored would fail above
            # (at Sq 1 both masks are one)
            line["causal_diff"] = (kern(causal=True).float() - out.float()).abs().max().item()
            if not line["causal_diff"] > 10 * KERNEL_TOL:
                raise AssertionError(f"non-causal control: the causal result differs by "
                                     f"{line['causal_diff']} only (want > {10 * KERNEL_TOL})")
        _record(records, name, idx, main_case[name], line)
    check_batch_invariance(gen)


def check_batch_invariance(gen) -> None:
    """The same rows attended alone (B=1) and in a batch of 6 give the same
    bits: the kernel's splits and merge order do not depend on the batch
    (qwen2's 12 query heads on 2 KV heads, the paper pair's 32 on 8,
    zamba2's 32 on 32 at head_dim 64, granite-moe's 24 on 8 (G = 3) and
    qwen3-moe's 32 on 4 (G = 8) at head_dim 64, phi3-mini's 32 on 32 at
    head_dim 96, granite-34b's 48 on 1 (G = 48) at head_dim 128, and
    whisper-tiny's 6 on 6 at head_dim 64, causal and non-causal, the latter
    also at the encoder's 1500 rows over 1500 positions)."""
    from repro_torch.kernels import verify_attn

    dev = torch.device("cuda")
    verify = (5, 512, [205, 233, 240, 5, 5, 5])  # (Sq, Skv, kv_valid)
    encoder = (ENCDEC_F, ENCDEC_F, [ENCDEC_F] * 6)
    cases = [(kv, hq, hkv, d, True, verify) for kv, hq, hkv, d in (
        ("bf16", 12, 2, 128), ("int8", 12, 2, 128), ("bf16", 32, 8, 128), ("bf16", 32, 32, 64),
        ("bf16", 24, 8, 64), ("int8", 24, 8, 64), ("bf16", 32, 4, 64), ("bf16", 32, 32, 96),
        ("int8", 32, 32, 96), ("bf16", 48, 1, 128), ("int8", 48, 1, 128), ("bf16", 6, 6, 64))]
    cases += [("bf16", 6, 6, 64, False, verify), ("bf16", 6, 6, 64, False, encoder)]
    for kv, hq, hkv, d, causal, (sq, skv, kvv) in cases:
        k = torch.randn(2, 7, skv, hkv, d, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(2, 7, skv, hkv, d, generator=gen, device=dev).to(torch.bfloat16)
        ks = vs = None
        if kv == "int8":
            (k, ks), (v, vs) = _quantize(k), _quantize(v)
        q = torch.randn(6, sq, hq, d, generator=gen, device=dev).to(torch.bfloat16)
        kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
        slots = torch.tensor([3, 0, 5, 6, 6, 6], dtype=torch.int32, device=dev)
        sc = dict(layer=1, k_scale=ks, v_scale=vs, causal=causal)
        paged = verify_attn.verify_attention_paged(q, k, v, slots, kv_valid, **sc)
        dense = verify_attn.verify_attention_packed(q, k[:, :6], v[:, :6], kv_valid, **(
            sc if ks is None else dict(sc, k_scale=ks[:, :6], v_scale=vs[:, :6])))
        for b in range(6):
            one = lambda t: t[b:b + 1].contiguous()  # noqa: E731
            alone = verify_attn.verify_attention_paged(one(q), k, v, one(slots), one(kv_valid),
                                                       **sc)
            k1, v1 = k[:, b:b + 1].contiguous(), v[:, b:b + 1].contiguous()
            s1 = {} if ks is None else dict(k_scale=ks[:, b:b + 1].contiguous(),
                                             v_scale=vs[:, b:b + 1].contiguous())
            alone_dense = verify_attn.verify_attention_packed(one(q), k1, v1, one(kv_valid),
                                                              layer=1, causal=causal, **s1)
            torch.cuda.synchronize()
            if not torch.equal(alone[0], paged[b]) or not torch.equal(alone_dense[0], dense[b]):
                raise AssertionError(f"attention {kv} Hq={hq} Hkv={hkv} D={d} Sq={sq} causal="
                                     f"{causal}: row {b} alone differs from the batch of 6")
        print(f"kernel batch invariance {kv} Hq={hq} Hkv={hkv} D={d} Sq={sq} Skv={skv}"
              f"{'' if causal else ' non-causal'}: rows of a batch of 6 (paged and dense, "
              f"kv_valid {kvv}) equal the same rows alone, bit for bit", flush=True)


def check_ssd(records: dict) -> None:
    """The SSD scan against its plain version at the mamba2-370m and
    zamba2-1.2b widths, and at a mesh rank's heads: the last H of a conv
    output of H_all heads, as a model rank hands them over."""
    from repro_torch.kernels import ref, ssd_scan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # (B, S, H, P, N, chunk[, H_all])
    cases = [
        (1, 199, 32, 64, 128, 256),  # mamba2-370m prefill of a 200-token prompt: one ragged chunk
        (1, 512, 32, 64, 128, 256),  # two full chunks
        (2, 300, 32, 64, 128, 256),  # a full and a ragged chunk, B = 2
        (2, 64, 4, 16, 32, 16),      # reduced widths, four chunks
        (1, 199, 64, 64, 64, 256),   # zamba2-1.2b prefill: 64 heads, state 64
        (2, 64, 8, 16, 16, 16),      # reduced zamba2 (and mamba2): N 16
        # the mesh phase's prefills: a rank's 2 rows and its half of the heads
        (2, 199, 16, 64, 128, 256, 32),  # mamba2-370m: 16 of 32
        (2, 199, 32, 64, 64, 256, 64),   # zamba2-1.2b: 32 of 64
    ]
    for idx, (B, S, H, P, N, chunk, *h_all) in enumerate(cases):
        Ha = h_all[0] if h_all else H
        # x, B and C as the model hands them over: views of one conv output
        # (a mesh rank's heads: its slice of x, dt and A made contiguous)
        xbc = rnd(B, S, Ha * P + 2 * N).to(torch.bfloat16)
        x = xbc[..., :Ha * P].reshape(B, S, Ha, P)[:, :, Ha - H:]
        Bm, Cm = xbc[..., Ha * P:Ha * P + N], xbc[..., Ha * P + N:]
        dt = torch.nn.functional.softplus(rnd(B, S, Ha))[..., Ha - H:].contiguous()
        A = -torch.exp(rnd(Ha) * 0.5)[Ha - H:]
        h0 = rnd(B, H, P, N)
        kern = lambda: ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)  # noqa: E731
        plain = lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm, h0, chunk=chunk)  # noqa: E731
        (y, h), (y_p, h_p) = kern(), plain()
        torch.cuda.synchronize()
        errs = {}
        for what, got, want in (("y", y, y_p), ("state", h, h_p)):
            diff = (got.float() - want.float()).abs()
            errs[f"{what}_err"] = diff.max().item()
            rel = errs[f"{what}_rel_err"] = (diff / (1 + want.float().abs())).max().item()
            if not math.isfinite(rel) or rel > SSD_TOL[what]:
                raise AssertionError(f"ssd_scan case {idx}: {what} off by {rel} relative "
                                     f"> {SSD_TOL[what]}")
        bound = _ssd_bound(B, S, H, P, N, chunk)
        # max_abs_err: the larger of y's and the state's; each apart beside it
        line = {"case": idx, "name": "ssd_scan",
                "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={chunk}"
                         f"{f' (heads {Ha - H}..{Ha} of {Ha})' if h_all else ''}",
                "max_abs_err": max(errs["y_err"], errs["state_err"]), **errs,
                "ms": _time_ms(kern), "graph_ms": _graph_ms([kern] * GRAPH_CALLS),
                "plain_ms": _time_ms(plain), "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "bound_f32_ms": bound["f32_ms"],
                "library_ms": None}  # no single PyTorch call computes it
        _record(records, "ssd_scan", idx, 0, line)
    # the kernel takes P in 16-column slices; any other P is refused
    x = torch.zeros((1, 32, 2, 24), dtype=torch.bfloat16, device=dev)
    bc = torch.zeros((1, 32, 32), dtype=torch.bfloat16, device=dev)
    try:
        ssd_scan.ssd_scan(x, torch.ones((1, 32, 2), device=dev), -torch.ones(2, device=dev), bc,
                          bc, chunk=16)
    except ValueError as e:
        print(f"kernel ssd_scan refuses P=24: {e}", flush=True)
    else:
        raise AssertionError("ssd_scan took P=24, which its 16-column slices do not cover")


# the SSD backward's bound: each of dx, ddt, dA, dB, dC and dh0 within this
# share of its largest element (max |kernel - plain| / max |plain|) of the
# plain backward (kernels/ref.py ssd_scan_bwd_ref) on the card. On the CPU
# the plain backward is within 1e-5 of autograd of the plain scan for the
# f32 outputs (dA 6e-5: a sum whose terms cancel) and rounds dx, dB and dC
# to the same bf16 values (tests/test_torch_ssd_grad.py); here the kernels
# sum in another order, so a bf16 output may land one step (2^-8 of an
# element, at most 3.9e-3 of the largest) from the plain one. 1e-2 is ~2.5
# such steps; a running sum of dt * A that leaves out each step's own term
# (exclusive instead of inclusive, the control below) moves some output by
# 0.17 or more at these inputs
SSD_GRAD_TIGHT = 1e-2
# (B, S, H, P, N, chunk): check_ssd's six cases, then the training rows of
# mamba2-370m and zamba2-1.2b (B 8, S 128: one chunk of 128 rows), then the
# chunk pass's edges at other widths: P and N of three 16-wide k slices (the
# Gram blocks' alternating sums) over a ragged second chunk, and N 256 at P
# 48 in one 161-row chunk (the state in strips, the P group narrowed, k
# slabs of 8 in every product with the state, two N groups)
SSD_BWD_CASES = [
    (1, 199, 32, 64, 128, 256), (1, 512, 32, 64, 128, 256), (2, 300, 32, 64, 128, 256),
    (2, 64, 4, 16, 32, 16), (1, 199, 64, 64, 64, 256), (2, 64, 8, 16, 16, 16),
    (8, 128, 32, 64, 128, 256), (8, 128, 64, 64, 64, 256),
    (1, 100, 5, 48, 48, 64), (1, 161, 2, 48, 256, 256),
]


def _ssd_bwd_bound(B, S, H, P, N, chunk) -> dict:
    """Least time for one SSD backward: its inputs (x, dt, A, B, C, the chunk
    states, dy, dh_out) read and outputs (dx, ddt, dA, dB, dC, dh0) written
    once at the HBM rate, or its operations at each precision's peak,
    whichever is larger. Per (b, chunk of q rows): C.B^T over the triangle
    (bf16). Per (b, h, chunk): dy.x^T over the triangle (bf16); on the tf32
    cores y's carry-in and intra terms, dC's two, U = V^T dy, T = B dh^T,
    dB's two and the reverse pass's dy^T C (5 qPN + 2 tri P + 2 tri N
    multiply-adds; the kernels' 2xTF32 runs each twice, which the bound does
    not count); on the f32 cores ~6 operations a triangle element (the decay,
    V, W, dS), ~10 a row and 2PN (dh h, the decay of dh)."""
    Q = min(chunk, S)
    nc = -(-S // Q)
    nbytes = (3 * B * S * H * P * 2 + 2 * B * S * H * 4 + 2 * H * 4
              + 2 * 2 * B * S * N * 2 + B * nc * H * P * N * 4 + 2 * B * H * P * N * 4)
    cb = mm = vec = 0
    for t0 in range(0, S, Q):
        q = min(Q, S - t0)
        tri = q * (q + 1) // 2
        cb += B * 2 * tri * N + B * H * 2 * tri * P
        mm += B * H * 2 * (5 * q * P * N + 2 * tri * P + 2 * tri * N)
        vec += B * H * (6 * tri + 10 * q + 2 * P * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (cb / BF16_FLOPS + mm / TF32_FLOPS + vec / F32_FLOPS) * 1e3
    return {"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops else {
        "bound_ms": t_ops, "bound_by": "operations"}


def check_ssd_bwd(records: dict) -> None:
    """The SSD scan's backward kernels on the forward kernel's chunk states
    against the plain backward at SSD_BWD_CASES with a start state and both
    cotangents: each output within SSD_GRAD_TIGHT, two calls bit-equal, the
    exclusive-cumsum control beyond the bound; the forward's chunk states
    against the plain scan's (SSD_TOL's state limit), its y and state the
    same bits with and without them; graph, eager and plain ms beside the
    bound (no PyTorch call computes it: library none)."""
    from repro_torch.kernels import ref, ssd_scan

    print("kernel ssd backward, nvcc: "
          + _ptxas_report(BUILD_LOGS.get("ssd_scan", ""),
                          ("ssd_gram_kernel", "ssd_scan_kernel", "ssd_bwd_dstate_kernel",
                           "ssd_bwd_chunk_kernel", "ssd_bwd_reduce_kernel")), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def exclusive(v):
        return torch.cumsum(v, dim=1) - v

    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    for idx, (B, S, H, P, N, chunk) in enumerate(SSD_BWD_CASES):
        xbc = rnd(B, S, H * P + 2 * N).to(torch.bfloat16)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = torch.nn.functional.softplus(rnd(B, S, H))
        A = -torch.exp(rnd(H) * 0.5)
        h0, dh = rnd(B, H, P, N), rnd(B, H, P, N)
        dy = rnd(B, S, H, P).to(torch.bfloat16)
        y, h, states = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk, return_states=True)
        y2, h2 = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)
        kern = lambda: ssd_scan.ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, dh,  # noqa: E731
                                             chunk=chunk)
        plain = lambda: ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dh,  # noqa: E731
                                             chunk=chunk)
        got, again, want = kern(), kern(), plain()
        late = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk, cumsum=exclusive)
        _, _, plain_states = ref.ssd_scan_ref(x, dt, A, Bm, Cm, h0, chunk=chunk,
                                              return_states=True)
        torch.cuda.synchronize()
        shape = f"B={B} S={S} H={H} P={P} N={N} chunk={chunk}"
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            raise AssertionError(f"ssd_scan {shape}: y or the state differs with the states")
        state_rel = ((states - plain_states).abs() / (1 + plain_states.abs())).max().item()
        if not state_rel <= SSD_TOL["state"]:
            raise AssertionError(f"ssd_scan {shape}: the chunk states are {state_rel} off "
                                 f"(> {SSD_TOL['state']})")
        errs = {n: _rel(g, w) for n, g, w in zip(names, got, want)}
        bad = [n for n in names if not errs[n] <= SSD_GRAD_TIGHT]
        if bad:
            raise AssertionError(f"ssd_scan_bwd {shape}: {bad} off ({errs}; bound "
                                 f"{SSD_GRAD_TIGHT} of the largest element)")
        for n, g, a in zip(names, got, again):
            if not torch.equal(g, a):
                raise AssertionError(f"ssd_scan_bwd {shape}: {n} differs between calls")
        errs["exclusive_cumsum"] = max(_rel(g, w) for g, w in zip(late, want))
        if not errs["exclusive_cumsum"] > SSD_GRAD_TIGHT:
            raise AssertionError(f"ssd_scan_bwd {shape}: the exclusive-cumsum control is only "
                                 f"{errs['exclusive_cumsum']} off (<= {SSD_GRAD_TIGHT})")
        errs["states_rel"] = state_rel
        bound = _ssd_bwd_bound(B, S, H, P, N, chunk)
        line = {"case": idx, "name": "ssd_scan_bwd", "shape": shape,
                "max_abs_err": max(_abs(g, w) for g, w in zip(got, want)),
                "max_rel_err": max(errs[n] for n in names), "errs": errs,
                "ms": _time_ms(kern, 20), "graph_ms": _graph_ms([kern] * GRAD_CALLS),
                "plain_ms": _time_ms(plain, 3), "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "library_ms": None}
        _record(records, "ssd_scan_bwd", idx, 6, line)
        del got, again, want, late


# the attention backward's bound: each of dQ, dK and dV within this share
# of its largest element (max |kernel - plain| / max |plain|) of the plain
# version's autograd gradient on the card. The plain backward
# (kernels/ref.py attention_bwd_ref, the kernels' decomposition and
# roundings) is within 6.2e-3 of that gradient on the CPU at the tested
# shapes (P rounded to bf16 after the division by the row sum instead of
# before, Delta from the bf16 O), so 2e-2 is ~3x that; a causal limit one
# position late moves the gradients by 0.14 to 3 of their largest element
# (tests/test_torch_training.py), so it fails this bound (the control below)
GRAD_TIGHT = 2e-2
# the backward's row statistics (LSE, Delta): f32 sums in another order
STATS_TIGHT = 1e-4
# (label, B, Sq, Skv, Hq, Hkv, D, kv_valid, causal): qwen2-1.5b's training
# rows (the main case), whisper-tiny's encoder, its decoder's self- and
# cross-attention at the launcher's B 8, S 128, small rows at G 3, 4
# (causal offset, Sq < Skv), 8 and 48 and at D 16 and 96, and the edges of
# the kernels' 64 x 64 tiles: a ragged position block and query tile under
# a head split (G 6, D 128), and D 96 with Sq not a multiple of 64 (entry
# 1's first 23 rows see no position)
BWD_CASES = [
    ("qwen2 train", 8, 128, 128, 12, 2, 128, [128] * 8, True),
    ("whisper encoder", 2, ENCDEC_F, ENCDEC_F, 6, 6, 64, [ENCDEC_F] * 2, False),
    ("whisper cross", 8, 128, ENCDEC_F, 6, 6, 64, [ENCDEC_F] * 8, False),
    ("whisper self", 8, 128, 128, 6, 6, 64, [128] * 8, True),
    ("G 3", 2, 37, 37, 24, 8, 64, [37, 37], True),
    ("G 4 offset", 2, 29, 70, 32, 8, 128, [70, 45], True),
    ("G 8", 2, 20, 20, 32, 4, 64, [20, 20], True),
    ("G 48 offset", 1, 16, 40, 48, 1, 128, [40], True),
    ("D 16", 2, 16, 16, 4, 2, 16, [16, 16], True),
    ("D 96", 2, 33, 33, 32, 32, 96, [33, 33], True),
    ("non-causal Sq < Skv", 2, 7, 50, 6, 6, 64, [50, 23], False),
    ("G 6 ragged", 2, 100, 200, 12, 2, 128, [200, 131], True),
    ("D 96 ragged", 2, 100, 100, 8, 4, 96, [100, 77], True),
]


def _bwd_bound(kind, B, Sq, Skv, Hq, Hkv, D, kvv, causal) -> tuple:
    """Least time for one backward kernel: the bytes it must move once (its
    inputs read, its outputs written; K and V as far as the largest
    kv_valid) at the HBM rate, or its products' operations over the visible
    (row, position) pairs at the bf16 peak, whichever is larger: per pair
    2D each for S, dP, dV, dK (dkdv), for S, dP, dQ (dq); delta reads O and
    dO and writes Delta, 2D operations a row and head."""
    pairs = 0
    for n in kvv:
        n = min(Skv, int(n))
        for i in range(Sq):
            pairs += max(0, min(n, n - Sq + i + 1)) if causal else n
    pairs *= Hq
    rows = B * Sq * Hq * D * 2            # one (B, Sq, Hq, D) bf16 tensor
    kv = B * min(Skv, max(kvv)) * Hkv * D * 2
    stats = B * Hq * Sq * 4               # one (B, Hq, Sq) f32 tensor
    nbytes, ops = {
        "attn_bwd_delta": (2 * rows + stats, 2 * D * B * Sq * Hq),
        "attn_bwd_dkdv": (2 * rows + 2 * kv + 2 * stats + 2 * B * Skv * Hkv * D * 2,
                          8 * D * pairs),
        "attn_bwd_dq": (3 * rows + 2 * kv + 2 * stats, 6 * D * pairs),
    }[kind]
    t_bytes = (nbytes + B * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _abs(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    return _abs(got, want) / want.float().abs().max().item()


def _ptxas_report(log: str, kernels) -> str:
    """``kernel<D>: N registers, S spill bytes`` (``kernel<P,N>:`` with two
    template arguments, ``kernel:`` where it is no template) for each
    instantiation of ``kernels`` in nvcc's -Xptxas -v report (spill stores
    + loads)."""
    import re

    out, name, spill = [], None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:  # mangled: <length><name>[I(Li<D>E)+E]E
            entry = re.search(r"\d([a-z_]+)(?:I((?:Li\d+E)+)E|E)", ln)
            name = None
            if entry and entry.group(1) in kernels:
                args = re.findall(r"Li(\d+)E", entry.group(2) or "")
                name = entry.group(1) + (f"<{','.join(args)}>" if args else "")
        elif name and "spill stores" in ln:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", ln))
        elif name and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, {spill} spill bytes")
            name = None
    return "; ".join(out) or "no report (the library was not rebuilt in this run)"


def check_attention_bwd(records: dict) -> None:
    """The three backward kernels, on the LSE the forward kernel keeps,
    against the plain version's autograd gradient on the card at BWD_CASES
    (dQ, dK, dV within GRAD_TIGHT; the forward's output with the LSE equal
    to its output without it bit for bit; the LSE against attention_lse_ref
    and Delta against attention_bwd_delta_ref within STATS_TIGHT), two calls
    bit-equal, the first and last batch entries alone (forward and
    backward) equal to the same entries in the batch; the off-by-one control
    at every causal case; graph and eager ms beside the bound, the plain
    parts' ms and SDPA's autograd backward on the same rows (eager; by graph
    as forward and backward less forward), a yardstick the port never
    calls, and the three kernels' graph ms summed beside it; at the three
    training shapes (the first three rows) the forward's graph ms with and
    without the LSE beside SDPA's forward."""
    from repro_torch.kernels import attn_bwd, ref, verify_attn

    print("kernel attention backward, nvcc: "
          + _ptxas_report(BUILD_LOGS.get("attn_bwd", ""),
                          ("delta_kernel", "dkdv_kernel", "dq_kernel")), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    for idx, (label, B, Sq, Skv, Hq, Hkv, D, kvv, causal) in enumerate(BWD_CASES):
        q, k, v = rnd(B, Sq, Hq, D), rnd(B, Skv, Hkv, D), rnd(B, Skv, Hkv, D)
        kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
        kw = dict(causal=causal)
        fwd = lambda: verify_attn.verify_attention_packed(q, k, v, kv_valid, **kw)  # noqa: E731
        fwd_lse = lambda: verify_attn.verify_attention_packed(  # noqa: E731
            q, k, v, kv_valid, return_lse=True, **kw)
        out, lse = fwd_lse()
        out_no_lse = fwd()
        dout = rnd(B, Sq, Hq, D)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(
            ref.verify_attention_ref(*leaves, kv_valid, **kw), leaves, dout)
        delta = lambda: attn_bwd.delta(out, dout)  # noqa: E731
        dl = delta()
        dkdv = lambda: attn_bwd.dkdv(q, k, v, dout, kv_valid, lse, dl, **kw)  # noqa: E731
        dq = lambda: attn_bwd.dq(q, k, v, dout, kv_valid, lse, dl, **kw)  # noqa: E731
        (dk, dv), dqv = dkdv(), dq()
        torch.cuda.synchronize()
        if not torch.equal(out, out_no_lse):
            raise AssertionError(f"attention backward {label}: the forward's output with the "
                                 "LSE differs from its output without it")
        plain_lse = ref.attention_lse_ref(q, k, kv_valid, **kw)
        plain_delta = ref.attention_bwd_delta_ref(out, dout)
        errs = {"lse": _rel(lse, plain_lse), "delta": _rel(dl, plain_delta),
                "dq": _rel(dqv, want[0]), "dk": _rel(dk, want[1]), "dv": _rel(dv, want[2])}
        plain_bwd = ref.attention_bwd_ref(q, k, v, out, dout, kv_valid, **kw)
        errs.update({f"{n}_vs_ref_bwd": _rel(g, w) for n, g, w in
                     zip(("dq", "dk", "dv"), (dqv, dk, dv), plain_bwd)})
        abs_errs = {"delta": _abs(dl, plain_delta),
                    "dkdv": max(_abs(dk, want[1]), _abs(dv, want[2])), "dq": _abs(dqv, want[0])}
        rel_errs = {"delta": errs["delta"], "dkdv": max(errs["dk"], errs["dv"]),
                    "dq": errs["dq"]}
        bad = [n for n in ("dq", "dk", "dv") if not errs[n] <= GRAD_TIGHT]
        bad += [n for n in ("lse", "delta") if not errs[n] <= STATS_TIGHT]
        if bad:
            raise AssertionError(f"attention backward {label}: {bad} off ({errs}; bounds "
                                 f"{GRAD_TIGHT} and {STATS_TIGHT} of the largest element)")
        if causal:  # the control: a causal limit one position late fails the bound
            late = ref.attention_bwd_ref(q, k, v, out, dout, kv_valid + 1, **kw)
            errs["late_by_one"] = max(_rel(g, w) for g, w in zip(late, want))
            if not errs["late_by_one"] > GRAD_TIGHT:
                raise AssertionError(f"attention backward {label}: a limit one position late "
                                     f"is only {errs['late_by_one']} off (<= {GRAD_TIGHT})")
        # determinism and batch invariance
        again = (*fwd_lse(), delta(), *dkdv(), dq())
        for name, a, b in zip(("out", "lse", "delta", "dk", "dv", "dq"), again,
                              (out, lse, dl, dk, dv, dqv)):
            if not torch.equal(a, b):
                raise AssertionError(f"attention backward {label}: {name} differs between calls")
        for b in {0, B - 1}:
            q1, k1, v1, dout1, kv1 = (t[b:b + 1].contiguous() for t in (q, k, v, dout, kv_valid))
            o1, l1 = verify_attn.verify_attention_packed(q1, k1, v1, kv1, return_lse=True, **kw)
            gq, gk, gv = attn_bwd.attention_bwd(q1, k1, v1, o1, dout1, kv1, l1, **kw)
            if not (torch.equal(o1[0], out[b]) and torch.equal(l1[0], lse[b])
                    and torch.equal(gq[0], dqv[b]) and torch.equal(gk[0], dk[b])
                    and torch.equal(gv[0], dv[b])):
                raise AssertionError(f"attention backward {label}: entry {b} alone differs "
                                     "from the batch")
        # times
        big = Sq * Skv > 10**6
        iters, calls = (5, 8) if big else (30, GRAD_CALLS)
        sdpa_args = _sdpa_inputs(q, k, v, kv_valid, causal=causal)
        dout_h = dout.transpose(1, 2)

        def leaves():
            return [t.detach().clone().requires_grad_() for t in sdpa_args[:3]]

        eager = leaves()
        o_lib = sdpa(*eager, attn_mask=sdpa_args[3])
        lib_bwd = lambda: torch.autograd.grad(o_lib, eager, dout_h,  # noqa: E731
                                              retain_graph=True)
        lib_ms = _time_ms(lib_bwd, iters)
        lib_graph = lib_fwd_graph = None
        # SDPA's backward captured with leaves the eager calls never touched
        # (the first case's capture was invalidated when it shared them)
        try:
            graphed = leaves()
            lib_fwd = lambda: sdpa(*graphed, attn_mask=sdpa_args[3])  # noqa: E731
            lib_both = lambda: torch.autograd.grad(lib_fwd(), graphed, dout_h)  # noqa: E731
            lib_fwd_graph = _graph_ms([lib_fwd] * calls)
            lib_graph = _graph_ms([lib_both] * calls) - lib_fwd_graph
        except Exception as e:  # noqa: BLE001 - a yardstick only
            print(f"kernel attention backward {label}: SDPA backward not captured in a graph "
                  f"({type(e).__name__}: {str(e).splitlines()[0]}); not measured", flush=True)
        plain = {
            "attn_bwd_delta": lambda: ref.attention_bwd_delta_ref(out, dout),
            "attn_bwd_dkdv": lambda: ref.attention_bwd_dkdv_ref(q, k, v, dout, kv_valid, lse,
                                                                dl, **kw),
            "attn_bwd_dq": lambda: ref.attention_bwd_dq_ref(q, k, v, dout, kv_valid, lse, dl,
                                                            **kw),
        }
        graph_sum = 0.0
        for name, fn in (("attn_bwd_delta", delta), ("attn_bwd_dkdv", dkdv),
                         ("attn_bwd_dq", dq)):
            err_key = name[len("attn_bwd_"):]
            bound_ms, bound_by = _bwd_bound(name, B, Sq, Skv, Hq, Hkv, D, kvv, causal)
            line = {"case": idx, "name": name, "shape": f"{label}: B={B} Sq={Sq} Skv={Skv} "
                    f"Hq={Hq} Hkv={Hkv} D={D} kv_valid={kvv}{'' if causal else ' non-causal'}",
                    "max_abs_err": abs_errs[err_key], "max_rel_err": rel_errs[err_key],
                    "errs": errs,
                    "ms": _time_ms(fn, iters), "graph_ms": _graph_ms([fn] * calls),
                    "plain_ms": _time_ms(plain[name], max(iters // 5, 2)),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    # SDPA's backward computes dQ, dK and dV at once: the
                    # yardstick of the three kernels' sum, beside dq and dkdv
                    "library_ms": None if name == "attn_bwd_delta" else lib_ms,
                    "library_graph_ms": None if name == "attn_bwd_delta" else lib_graph}
            graph_sum += line["graph_ms"]
            _record(records, name, idx, 0, line)
        lib_txt = ("not measured" if lib_graph is None
                   else f"{lib_graph:.4f} ms (the kernels {graph_sum / lib_graph:.3f}x)")
        print(f"kernel attention backward {label}: delta + dkdv + dq {graph_sum:.4f} ms by "
              f"graph, SDPA's whole backward {lib_txt}", flush=True)
        if idx < 3:  # the training shapes: the forward with and without the LSE
            bound_ms, bound_by = _bound(q, kvv, None, Skv, Hkv, Hq // Hkv, causal=causal,
                                        lse=True)
            fline = {"shape": f"{label}: B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} D={D}"
                     f"{'' if causal else ' non-causal'}",
                     "graph_ms": _graph_ms([fwd] * calls),
                     "lse_graph_ms": _graph_ms([fwd_lse] * calls),
                     "ms": _time_ms(fwd, iters), "lse_ms": _time_ms(fwd_lse, iters),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_graph_ms": lib_fwd_graph, "lse_max_abs_err": _abs(lse, plain_lse),
                     "lse_max_rel_err": errs["lse"]}
            fline["lse_over_without"] = fline["lse_graph_ms"] / fline["graph_ms"]
            records["verify_attention_packed"].setdefault("training_forward", []).append(fline)
            print("kernel attention forward", json.dumps(fline), flush=True)


# the shard form's cases: (B, Sq, Hq, Hkv, D, S_loc, kv_valid, pos_offset,
# layers). The mesh phase's granite-34b (48 query heads on 1 KV head of 128,
# a cache of 4096 positions in shards of 2048, B 2 a rank, 16 layers): a
# verify whose shard lies wholly in the past, the first verify's straddling
# rows (positions 2045..2049) against shard 0 and shard 1, a shard that sees
# nothing, and the prefill's 2045 rows against shard 0; then qwen2-1.5b's
# training rows (B 8, 128 rows, 12 on 2 heads) over the two halves of their
# sequence
SHARD_CASES = [
    (2, 5, 48, 1, 128, 2048, [4000, 3000], 0, 16),
    (2, 5, 48, 1, 128, 2048, [2050, 2050], 0, 16),
    (2, 5, 48, 1, 128, 2048, [2050, 2050], 2048, 16),
    (2, 5, 48, 1, 128, 2048, [2000, 1500], 2048, 16),
    (2, 2045, 48, 1, 128, 2048, [2045, 2045], 0, 16),
    (8, 128, 12, 2, 128, 64, [128] * 8, 0, 0),
    (8, 128, 12, 2, 128, 64, [128] * 8, 64, 0),
]
SHARD_MAIN = 1  # the mesh verify's straddling rows on shard 0: the record's time


def _shard_bound(B, Sq, Hq, Hkv, D, skv, kvv, off) -> tuple:
    """Least time for one shard-form call: the K/V rows of the shard that
    some query sees (each once), q read, the f32 output and LSE written,
    kv_valid read, at the HBM rate; or the two products over the positions
    each query row sees in the shard at the bf16 peak; the larger."""
    seen = [max(0, min(skv, int(n) - off)) for n in kvv]
    nbytes = (sum(seen) * Hkv * D * 2 * 2 + B * Sq * Hq * D * (2 + 4) + B * Sq * Hq * 4
              + B * 4)
    flops = 0
    for n in kvv:
        for i in range(Sq):
            flops += 2 * 2 * max(0, min(skv, int(n) - Sq + i + 1 - off)) * D * Hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _host_us(fn, iters: int = 50) -> float:
    """The host's microseconds to issue one call (no synchronize inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def check_attention_shard(records: dict) -> None:
    """The shard form (verify_attention_packed_shard) against its plain
    version at SHARD_CASES: the f32 output within KERNEL_TIGHT, the LSE
    within STATS_TIGHT of its largest finite element, -inf exactly where
    the plain version's is (a row that sees nothing of the shard) with
    output 0 there; a case whose every row sees nothing gives nothing else.
    The library yardstick is the one PyTorch call that returns output and
    LSE under an arbitrary mask: the efficient SDPA kernel with an additive
    bias (heads repeated, rows gathered beforehand)."""
    from repro_torch.kernels import ref, verify_attn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    name = "verify_attention_packed_shard"
    for idx, (B, Sq, Hq, Hkv, D, skv, kvv, off, L) in enumerate(SHARD_CASES):
        lead = (L,) if L else ()
        k, v, q = rnd(*lead, B, skv, Hkv, D), rnd(*lead, B, skv, Hkv, D), rnd(B, Sq, Hq, D)
        kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
        layer = L - 1 if L else None
        kc, vc = (k[layer], v[layer]) if L else (k, v)
        kern = lambda: verify_attn.verify_attention_packed_shard(  # noqa: E731
            q, k, v, kv_valid, pos_offset=off, layer=layer)
        plain = lambda: ref.verify_attention_shard_ref(q, kc, vc, kv_valid, off)  # noqa: E731
        out, lse = kern()
        want, want_lse = plain()
        torch.cuda.synchronize()
        empty = torch.isneginf(want_lse)
        if not torch.equal(torch.isneginf(lse), empty) or bool(torch.isnan(lse).any()):
            raise AssertionError(f"{name} case {idx}: -inf LSE rows differ from the plain version")
        rows_empty = empty.transpose(1, 2)  # (B, Sq, Hq)
        if bool(out[rows_empty].ne(0).any()):
            raise AssertionError(f"{name} case {idx}: a row that sees nothing is not 0")
        err = (out - want).abs().max().item()
        finite = ~empty
        lse_err = ((lse[finite] - want_lse[finite]).abs().max().item() if bool(finite.any())
                   else 0.0)
        lse_scale = want_lse[finite].abs().max().item() if bool(finite.any()) else 1.0
        if not math.isfinite(err) or err > KERNEL_TIGHT or lse_err > STATS_TIGHT * lse_scale:
            raise AssertionError(f"{name} case {idx}: max abs err {err} (bound {KERNEL_TIGHT}), "
                                 f"LSE err {lse_err} (bound {STATS_TIGHT} x {lse_scale})")
        bound_ms, bound_by = _shard_bound(B, Sq, Hq, Hkv, D, skv, kvv, off)
        # the library yardstick: output and LSE of every head under a bias
        # that is 0 where a position is visible and -inf elsewhere
        qpos = kv_valid[:, None].long() - Sq + torch.arange(Sq, device=dev)[None] - off
        vis = torch.arange(skv, device=dev)[None, None, :] <= qpos[:, :, None]
        bias = torch.zeros(B, 1, Sq, skv, dtype=torch.bfloat16, device=dev).masked_fill(
            ~vis[:, None], float("-inf")).expand(B, Hq, Sq, skv)
        G = Hq // Hkv
        qh = q.transpose(1, 2).contiguous()
        kh = kc.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vh = vc.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        lib = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731
            qh, kh, vh, bias, True)
        big = Sq * skv > 10**6
        iters, calls = (10, 8) if big else (50, GRAPH_CALLS)
        library_ms = library_graph_ms = None
        try:
            lib()
            library_ms = _time_ms(lib, 10)
            library_graph_ms = _graph_ms([lib] * calls)
        except RuntimeError as exc:  # the yardstick only; the port never calls it
            print(f"kernel shard library call refused: {str(exc)[:200]}", flush=True)
        line = {"case": idx, "name": name, "shape": f"B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
                f"S_loc={skv} kv_valid={kvv} pos_offset={off} layers={L}",
                "max_abs_err": err, "lse_max_abs_err": lse_err,
                "empty_rows": int(rows_empty.sum()), "ms": _time_ms(kern, iters),
                "graph_ms": _graph_ms([kern] * calls), "host_us": _host_us(kern, iters),
                "plain_ms": _time_ms(plain, 3 if big else 10), "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "library_graph_ms": library_graph_ms}
        _record(records, name, idx, SHARD_MAIN, line)


def check_kernels(records: dict) -> None:
    """Phase 2: every kernel against its plain version at the paths' shapes."""
    check_attention(records)
    check_attention_shard(records)
    check_ssd(records)
    check_ssd_bwd(records)
    check_attention_bwd(records)


def full_width_bundle(arch: str = "qwen2-1.5b", resid_scale: float = RESID_SCALE,
                      draft_layers: int = 1, target_layers: int = 0):
    """``arch`` at its published widths: the full-depth target (or its
    first ``target_layers`` layers, a depth cut) and a draft of
    ``draft_layers`` layers of the same architecture, with the port's
    seeded random init on the card.

    Every layer's output projections (qwen2: attention ``wo`` and MLP
    ``wd``; the moe family: ``wo`` and the experts' ``wd``; mamba2:
    ``out_proj``; zamba2: each SSD layer's ``out_proj`` and the shared
    block's ``wo`` and ``wd``) are scaled by ``resid_scale``, and the draft
    is the target's embedding, first layers (and zamba2's shared block),
    final norm and head. With the init's own scale the qwen2 layers swamp the embedding: both models'
    logits are flat over 151936 tokens, the draft stops at one token
    (confidence < c_th) and never agrees with the target. With smaller
    layer outputs the draft is confident and the target agrees with it
    where its further layers do not move the argmax; at RESID_SCALE some of
    the drafted tokens are accepted and some rejected, so rounds commit
    several tokens and also roll back."""
    from repro_torch.api import ModelBundle
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    tcfg = get_config(arch)
    if target_layers:
        tcfg = dataclasses.replace(tcfg, num_layers=target_layers)
    target = build_model(tcfg)
    tp = target.init_params(torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        blocks = list(tp.layers) + ([tp.shared] if tcfg.family == "hybrid" else [])
        for blk in blocks:
            if hasattr(blk, "out_proj"):  # an SSD layer
                blk.out_proj.mul_(resid_scale)
            else:
                blk.attn.wo.mul_(resid_scale)
                (blk.moe if tcfg.family == "moe" else blk.mlp).wd.mul_(resid_scale)
    dcfg, draft, dp = prefix_draft(tcfg, tp, draft_layers)
    return ModelBundle(tcfg, dcfg, target, draft, tp, dp)


def prefix_draft(tcfg, target_params, n_layers: int):
    """A draft of ``n_layers`` layers: copies of the target's embedding, its
    first ``n_layers`` layers and every weight outside the layers (final
    norm, head, a hybrid's shared block), as ``(cfg, model, params)``."""
    from repro_torch.models.model_zoo import build_model

    dcfg = dataclasses.replace(tcfg, name="edge-draft", num_layers=n_layers)
    draft = build_model(dcfg)
    dp = draft.init_params(torch.Generator(device="cuda").manual_seed(1))
    keep = tuple(f"layers.{i}." for i in range(n_layers))
    dp.load_state_dict({k: w for k, w in target_params.state_dict().items()
                        if not k.startswith("layers.") or k.startswith(keep)})
    return dcfg, draft, dp


def serve_spec(backend: str, arch: str = "qwen2-1.5b", kv_dtype: str = "bf16", *,
               bits: int = 16, draft_arch: str = "", draft_layers: int = 1,
               target_layers: int = 0, **changes):
    """The served fleet: 6 devices, prompt 200, 32 new tokens, greedy unless
    ``changes`` says otherwise (``greedy``, ``fleet``, ``paged_attention``).
    The draft is ``draft_layers`` layers of ``arch``, or the whole of
    ``draft_arch``; the target all of ``arch``'s layers or ``target_layers``."""
    from repro_torch.api import ModelSpec, ServeSpec
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if draft_arch:
        draft_layers = get_config(draft_arch).num_layers
    kw = dict(
        backend=backend,
        model=ModelSpec(arch=arch, draft_arch=draft_arch or arch, vocab_size=cfg.vocab_size,
                        target_layers=target_layers or cfg.num_layers, draft_layers=draft_layers,
                        bits=bits),
        devices=6, prompt_len=200, max_len=512, max_new=32, k_max=4, c_th=0.3,
        greedy=True, paged_attention=True, kv_dtype=kv_dtype,
    )
    return ServeSpec(**{**kw, **changes})


def _reset_launches() -> None:
    from repro_torch.kernels import attn_bwd, ssd_scan, verify_attn

    verify_attn.reset_launches()
    ssd_scan.reset_launches()
    attn_bwd.reset_launches()


def _launches() -> dict:
    from repro_torch.kernels import attn_bwd, ssd_scan, verify_attn

    return {**verify_attn.LAUNCHES, **ssd_scan.LAUNCHES, **attn_bwd.LAUNCHES}


def _round_sink(rounds: dict):
    """An on_event sink keeping each device's committed tokens per round."""
    from repro_torch.api.events import RoundEvent

    def sink(ev):
        if isinstance(ev, RoundEvent):
            rounds[ev.device_id].append(list(ev.tokens))
    return sink


def serve(label: str, records: dict, bundle, prompts, *, spec, path: dict, kits=None,
          need_accepted: bool = True, tally=None) -> dict:
    """The engine backend serves the fleet of ``spec``. ``path`` maps each
    kernel entry of this path to the launches it must show (None: at least
    one); a kernel record's ``launches`` is the count of the first path that
    runs it (its main path), ``launches_by_path`` every path's. Some drafts
    must be accepted unless ``need_accepted`` is False. A ``tally``
    (_MoeTally) is zeroed with the launch counters. Returns the
    streams (``outputs``), each device's committed tokens per round
    (``rounds``) and the padded batch each of those rounds ran in
    (``rows``), and the pool's bytes per slot (``per_slot``)."""
    from repro_torch.api import System

    system = System.build(spec, models=bundle, kits=kits)
    t0 = time.perf_counter()
    system.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rounds = {d: [] for d in range(len(prompts))}
    rows = {d: [] for d in range(len(prompts))}
    core, verify = system.engine.core, system.engine.core.verify

    def recorded_verify(slots, *args):
        out = verify(slots, *args)  # (result, bucket, seconds)
        device_of = {st.slot: d for d, st in system.engine.streams.items()}
        for slot in slots:
            rows[device_of[int(slot)]].append(out[1])
        return out

    core.verify = recorded_verify
    _reset_launches()
    if tally is not None:
        tally.reset()
    t0 = time.perf_counter()
    res = system.serve(prompts, on_event=_round_sink(rounds))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    st = res.engine
    per_slot = system.engine.pool.bytes_per_slot()
    print(f"serve {label}: engine backend, 6 devices, {res.total_tokens} tokens in {wall:.3f} s "
          f"({res.total_tokens / wall:.1f} tokens/s), warmup {warm_s:.2f} s, "
          f"rounds {st.rounds}, mean fill {st.mean_batch_fill:.2f}, "
          f"acceptance {st.acceptance_rate:.3f}, bytes_per_slot {per_slot}, "
          f"launches {launches}", flush=True)
    print(f"serve {label}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if need_accepted and st.acceptance_rate <= 0:
        raise AssertionError(f"{label}: no draft token was accepted: multi-token commits "
                             "went untested")
    if bundle.target_cfg.family in RECURRENT and st.acceptance_rate >= 1:
        raise AssertionError(f"{label}: every draft was accepted: state rollback went untested")
    _record_launches(label, records, path, launches)
    vocab = bundle.target_cfg.vocab_size
    for s in res.sessions:
        if len(s.tokens) != spec.max_new or not all(0 <= t < vocab for t in s.tokens):
            raise AssertionError(f"{label}: device {s.device_id}: bad output {s.tokens}")
        if len(rounds[s.device_id]) != len(rows[s.device_id]):
            raise AssertionError(f"{label}: device {s.device_id}: {len(rounds[s.device_id])} "
                                 f"rounds but {len(rows[s.device_id])} verify batches")
    return {"outputs": res.outputs, "rounds": rounds, "rows": rows, "per_slot": per_slot,
            "tokens_per_s": res.total_tokens / wall}


def _record_launches(label: str, records: dict, path: dict, launches: dict, *,
                     main_path: bool = True) -> None:
    """Each kernel entry of ``path`` must show the launches it maps to (None:
    at least one) in this path's run; a record's ``launches`` is the count
    of the first path that runs it (its main path) among those with
    ``main_path``, ``launches_by_path`` every path's."""
    for name, want in path.items():
        n = launches[name]
        rec = records[name]
        rec.setdefault("launches_by_path", {})[label] = n
        if main_path and not rec["launches"]:
            rec["launches"] = n
        if n <= 0 or (want is not None and n != want):
            raise AssertionError(f"{label}: {name} launched {n} times on the path "
                                 f"(expected {want if want is not None else '> 0'})")


def _first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _replay(bundle, spec, prompt, tokens, rounds, rows, prefill_rows, what: str) -> bool:
    """The target alone, replayed on one served stream's commit boundaries
    (``rounds``) with every product at the row count the stream ran at
    (``prefill_rows``; ``rows`` per round): True when each of the stream's
    tokens is the target's argmax there, or within LOGIT_TOL of it."""
    from repro_torch.core.engine_loop import replay_stream

    greedy, margin = replay_stream(
        bundle.target, bundle.target_params, prompt, rounds, k_max=spec.k_max,
        max_len=spec.max_len, prefill_rows=prefill_rows, rows=rows, attn_chunk=spec.attn_chunk)
    n = len(tokens)
    exact = int(np.sum(greedy[:n] == np.asarray(tokens)))
    worst = float(margin[:n].max())
    print(f"  replay of the {what}: {exact}/{n} tokens are the target's argmax "
          f"(largest logit shortfall {worst:.4g})", flush=True)
    return greedy.shape[0] >= n and worst < LOGIT_TOL


def check(label: str, bundle, prompts, served: dict, *, spec, lo: int = 0,
          witness: bool = False) -> None:
    """The port's reference backend (``spec``) on the same bundle and
    prompts: the engine's tokens (devices ``lo`` on of the served fleet)
    must equal the reference's, or diverge first where the reference's
    top-2 gap is below ``LOGIT_TOL`` (a near tie).

    mamba2 rounds its whole recurrent state to bf16 at every commit, so its
    stream also depends on where the commits fall (the drafts' acceptance)
    and on the row counts the products ran at, which differ between the
    backends: the reference prefills and verifies the 6 devices in one
    batch, the engine prefills each slot alone and verifies the rows ready
    in a round. A last-bit difference becomes thousands of one-ulp
    differences in the state (experiments/torch_batch_noise.py measures how
    far this moves the reference's own tokens). So for mamba2 every engine
    stream is also held to a witness that runs the served numerics: the
    target alone, replayed on the stream's own commit boundaries and batch
    shapes (engine_loop.replay_stream), must choose each of its tokens. At
    a divergence past a near tie the engine passes only if the same replay
    of the reference stream, on its boundaries and shapes, gives back the
    reference's tokens too: both streams are then the target's greedy
    streams of their own schedules. A wrong rollback or commit fails the
    engine's replay (tests/test_torch_serve.py rehearses one on the CPU).
    ``witness`` holds a dense model to the same witness: the paper's 11B
    (40 layers of d_model 4096) carries a last-bit difference of a product
    further than qwen2-1.5b does (PERF.md §6)."""
    from repro_torch.api import System

    ref_rounds = {d: [] for d in range(len(prompts))}
    t0 = time.perf_counter()
    ref_out = System.build(spec, models=bundle).serve(
        prompts, on_event=_round_sink(ref_rounds)).outputs
    print(f"check {label}: reference backend {time.perf_counter() - t0:.3f} s", flush=True)
    replay = witness or bundle.target_cfg.family in RECURRENT
    outputs = served["outputs"]
    for dev_id, want in ref_out.items():
        got = outputs[lo + dev_id]
        if replay:
            print(f"check {label}: device {lo + dev_id}", flush=True)
            if not _replay(bundle, spec, prompts[dev_id], got, served["rounds"][lo + dev_id],
                           served["rows"][lo + dev_id], 1, "engine stream"):
                raise AssertionError(f"{label}: device {lo + dev_id}: the engine committed a "
                                     "token the target does not choose on its own schedule")
        p = _first_difference(got, want)
        if p is None:
            continue
        gap = _top2_gap(bundle, prompts[dev_id], want[:p], spec.kv_dtype)
        print(f"check {label}: device {lo + dev_id} diverges at token {p} (engine {got[p]}, "
              f"reference {want[p]}); reference top-2 logit gap {gap:.4g}", flush=True)
        if gap < LOGIT_TOL:
            continue
        n = len(prompts)
        if not replay or not _replay(bundle, spec, prompts[dev_id], want, ref_rounds[dev_id],
                                     [n] * len(ref_rounds[dev_id]), n, "reference stream"):
            raise AssertionError(f"{label}: device {lo + dev_id}: divergence at token {p} with "
                                 f"top-2 gap {gap} >= {LOGIT_TOL}")
    print(f"check {label}: engine tokens == reference tokens on {len(ref_out)} devices "
          "(up to the divergences printed above)", flush=True)


def _top2_gap(bundle, prompt, prefix, kv_dtype) -> float:
    """Top-2 logit gap of the target at the first divergent position."""
    toks = torch.tensor(np.concatenate([prompt, np.asarray(prefix, np.int64)]),
                        dtype=torch.int32, device="cuda")[None]
    cache = bundle.target.make_cache(1, toks.shape[1] + 8, device="cuda", attn_chunk=32,
                                     kv_dtype=kv_dtype)
    logits, _ = bundle.target.prefill(bundle.target_params, toks, cache, attn_chunk=32)
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def _chi2_quantile_999(df: int) -> float:
    """The chi-square distribution's 0.999 quantile (Wilson-Hilferty; 104.8
    at df 64, where the exact value is 104.7)."""
    z = 3.090232  # the standard normal's 0.999 quantile
    return df * (1 - 2 / (9 * df) + z * math.sqrt(2 / (9 * df))) ** 3


def check_sampler(bundle, prompt, B: int = 8192) -> dict:
    """The rejection sampler on the card at one real verify position: the
    full-width target's logits p and the draft's q right after ``prompt``
    (where the first verify round judges the first draft), B copies, the
    draft tokens drawn from q by a card generator, one speculative_verify
    with the exact residual. The acceptance count must lie within 4 sigma
    of sum_b min(1, p(d_b)/q(d_b)) (sigma from the Bernoulli variances),
    and the first committed tokens must follow p: a chi-square over 65
    bins under the 0.999 quantile of its degrees of freedom (104.7 at 64).
    The bins cut p's tokens, in descending order of p, at multiples of 1/65
    of its mass: p's top tokens first, each bin expecting about B/65
    draws. (The random-init target's p is flat, its top token ~2e-4, so
    bins of single top tokens would expect under 2 draws each and leave
    the test nothing to count.) A bin expecting fewer than 5 draws is
    pooled into the last (the test's validity condition)."""
    from repro_torch.core.speculative import speculative_verify

    dev = torch.device("cuda")
    toks = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
    logits = []
    for model, params in ((bundle.target, bundle.target_params),
                          (bundle.draft, bundle.draft_params)):
        cache = model.make_cache(1, toks.shape[1] + 8, device=dev, attn_chunk=32)
        logits.append(model.prefill(params, toks, cache, attn_chunk=32)[0][0])
    p_logits, q = logits[0], torch.softmax(logits[1], dim=-1)
    V = p_logits.shape[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    d = torch.multinomial(q, B, replacement=True, generator=gen)
    # the bonus row (index 1) never decides the first committed token
    res = speculative_verify(d[:, None].to(torch.int32), p_logits.expand(B, 2, V), gen,
                             draft_q=q[d][:, None], draft_q_full=q.expand(B, 1, V),
                             greedy=False)
    p = torch.softmax(p_logits.double(), dim=-1)
    a = torch.clamp(p[d] / q[d].double(), max=1.0)
    mean, sigma = float(a.sum()), float((a * (1 - a)).sum().sqrt())
    count = int(res.n_accepted.sum())
    if sigma > 0:
        z = (count - mean) / sigma
    else:
        z = 0.0 if count == round(mean) else math.inf
    order = torch.argsort(p, descending=True)
    before = torch.cumsum(p[order], 0) - p[order]
    _, bin_of = torch.unique(torch.clamp((before * 65).long(), max=64), return_inverse=True)
    n_bins = int(bin_of.max()) + 1
    counts = torch.bincount(res.out_tokens[:, 0].long(), minlength=V)[order].double()
    obs = torch.zeros(n_bins, dtype=torch.float64, device=dev).index_add_(0, bin_of, counts)
    exp = torch.zeros(n_bins, dtype=torch.float64, device=dev).index_add_(0, bin_of, B * p[order])
    keep = exp >= 5
    obs = torch.cat([obs[keep], obs[~keep].sum()[None]])
    exp = torch.cat([exp[keep], exp[~keep].sum()[None]])
    if exp[-1] < 5:  # nothing (or too little) pooled: the last kept bin takes it
        obs = torch.cat([obs[:-2], obs[-2:].sum()[None]])
        exp = torch.cat([exp[:-2], exp[-2:].sum()[None]])
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    df = int(obs.numel()) - 1
    limit = _chi2_quantile_999(df) if df >= 1 else 0.0
    out = {"B": B, "accepted": count, "analytic": mean, "sigma": sigma, "z": z,
           "chi2": chi2, "df": df, "chi2_limit": limit, "top1_p": float(p.max()),
           "beta": float(torch.minimum(p, q.double()).sum())}
    print("sampler", json.dumps(out), flush=True)
    del res
    torch.cuda.empty_cache()
    if not abs(z) <= 4:
        raise AssertionError(f"sampler: acceptance count {count} is {z:.2f} sigma from {mean:.1f}")
    if df < 1 or not chi2 < limit:
        raise AssertionError(f"sampler: chi-square {chi2:.2f} over {df} df, limit {limit:.2f}")
    return out


class _FiniteWatch:
    """Wraps a model's lm_head: each call ANDs "every logit is finite" into
    a flag on the card (no host sync)."""

    def __init__(self):
        self.ok = torch.ones((), dtype=torch.bool, device="cuda")

    def wrap(self, model):
        def lm_head(params, h):
            out = model.lm_head(params, h)
            self.ok &= torch.isfinite(out).all()
            return out
        return dataclasses.replace(model, lm_head=lm_head)


def serve_sample(records: dict, bundle, prompts) -> dict:
    """The engine backend with greedy=False (temperature 1): every draw on
    the card, no logit of the target or the drafts (whose softmax is q) NaN
    or infinite, every token in the vocabulary (serve() checks it)."""
    target_watch, draft_watch = _FiniteWatch(), _FiniteWatch()
    watched = dataclasses.replace(bundle, target=target_watch.wrap(bundle.target),
                                  draft=draft_watch.wrap(bundle.draft))
    served = serve("sample", records, watched, prompts, spec=serve_spec("engine", greedy=False),
                   path=BF16_PATH)
    if not (bool(target_watch.ok) and bool(draft_watch.ok)):
        raise AssertionError(f"sample: a logit was not finite (target ok {bool(target_watch.ok)},"
                             f" drafts ok {bool(draft_watch.ok)})")
    return served


def quantize_bundle(bundle, bits: int):
    """The target weight-quantized to ``bits`` and dequantized on the card,
    as ``build_models`` does for ``ModelSpec(bits=...)``; the draft as it
    is. Prints ``quant_error`` at 8 and 4 bits and ``quantized_bytes``
    against the 16-bit bytes."""
    from repro_torch import quant

    tp = bundle.target_params
    stats = {"quant_error_8": quant.quant_error(tp, 8), "quant_error_4": quant.quant_error(tp, 4),
             **{f"bytes_{b}": quant.quantized_bytes(tp, b) for b in (16, 8, 4)}}
    stats["bytes_8_over_16"] = stats["bytes_8"] / stats["bytes_16"]
    stats["bytes_4_over_16"] = stats["bytes_4"] / stats["bytes_16"]
    print("quant", json.dumps(stats), flush=True)
    q = dataclasses.replace(bundle, target_params=quant.dequantize_pytree(
        quant.quantize_pytree(tp, bits)))
    torch.cuda.empty_cache()
    return q, stats


def fleet_spec():
    """Two classes of 3 devices: Jetson Orin Nano drafting 4 tokens at c_th
    0.3 with a 1-layer draft, Raspberry Pi 4B drafting 2 at c_th 0.5 with a
    2-layer draft (the rate table's entry of tests/test_fleet.py)."""
    from repro_torch.api.spec import DeviceClassSpec, FleetSpec

    common = dict(count=3, draft_model="llama-1b-draft", bits=4)
    return serve_spec("engine", fleet=FleetSpec(classes=(
        DeviceClassSpec(profile="jetson-orin-nano", k=4, c_th=0.3, draft_layers=1, **common),
        DeviceClassSpec(profile="rpi4b", k=2, c_th=0.5, draft_layers=2, **common),
    )))


def serve_fleet(records: dict, bundle, prompts) -> None:
    """The engine backend serves the fleet, each class drafting with its own
    kit; class drafts are prefixes of the full-width target (random-init
    class drafts would accept nothing), put in a KitCache. Each class's
    streams are held to its own reference (``fleet_reference_specs()``)
    with check(); a class drafting k tokens commits at most k + 1 a round."""
    spec = fleet_spec()
    kits, bundles = fleet_kits(bundle, spec)
    served = serve("fleet", records, bundle, prompts, spec=spec, kits=kits, path=BF16_PATH)
    check_fleet("fleet", bundles, prompts, served, spec=spec)


def fleet_kits(bundle, spec):
    """The fleet's class drafts as prefixes of the full-width target, in a
    KitCache (random-init class drafts would accept nothing), and each
    class's bundle for its reference."""
    from repro_torch.api import KitCache

    kits, bundles = KitCache(), []
    for rc in spec.resolved_classes():
        if rc.draft_layers == spec.model.draft_layers:
            bundles.append(bundle)
            continue
        dcfg, draft, dp = prefix_draft(bundle.target_cfg, bundle.target_params, rc.draft_layers)
        kits.drafts[(spec.model.draft_arch, rc.draft_layers, rc.draft_noise,
                     spec.model.vocab_size, spec.model.seed)] = (dcfg, draft, dp)
        bundles.append(dataclasses.replace(bundle, draft_cfg=dcfg, draft=draft, draft_params=dp))
    return kits, bundles


def check_fleet(label: str, bundles, prompts, served: dict, *, spec) -> None:
    """Each class's streams against its own reference (check()); a class
    drafting k tokens commits at most k + 1 a round."""
    for rc, (lo, hi, refspec) in zip(spec.resolved_classes(), spec.fleet_reference_specs()):
        longest = max(len(r) for d in range(lo, hi) for r in served["rounds"][d])
        print(f"{label} class {rc.index} ({rc.spec.profile}, k {rc.k}, c_th {rc.c_th}, "
              f"{rc.draft_layers}-layer draft): most tokens committed in a round {longest}",
              flush=True)
        if longest > rc.k + 1:
            raise AssertionError(f"{label} class {rc.index}: a round committed {longest} "
                                 f"tokens, more than k + 1 = {rc.k + 1}")
        check(f"{label} class {rc.index}", bundles[rc.index], prompts[lo:hi], served,
              spec=refspec, lo=lo)


def _drive_sessions(system, prompts, budgets, on_event) -> dict:
    """Every device's session pumped in turn until all finish (budgets may
    differ); device -> committed tokens."""
    sessions = [system.open_session(prompts[i], device_id=i, max_new=budgets[i])
                for i in range(len(budgets))]
    gens = [sess.generate() for sess in sessions]
    while not all(sess.done for sess in sessions):
        for sess, gen in zip(sessions, gens):
            ev = next(gen, None)  # an event of this session, or one pump of them all
            if ev is not None:
                on_event(ev)
    return {sess.device_id: sess.result.tokens for sess in sessions}


def serve_cluster(label: str, records: dict, bundle, prompts, *, kv_dtype: str,
                  engine_tps: float) -> dict:
    """The cluster backend: 2 in-process replicas x 4 slots, round-robin
    placement, 8 devices. Even ids stop after 8 tokens and odd ids after 32,
    so replica 0 (the even ids) empties first and retirement must migrate
    streams (their rows, int8 scales included, copied bit for bit). The
    engine backend first serves the same sessions on one replica of 8
    slots, as the cluster's yardstick (its tokens are not checked)."""
    from repro_torch.api import System
    from repro_torch.api.spec import ClusterSpec

    spec = serve_spec("cluster", kv_dtype=kv_dtype, devices=8,
                      cluster=ClusterSpec(replicas=2, placement="round-robin"))
    budgets = [8 if i % 2 == 0 else 32 for i in range(len(prompts))]
    one = System.build(spec.with_backend("engine"), models=bundle)
    one.warmup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    same = _drive_sessions(one, prompts, budgets, lambda ev: None)
    torch.cuda.synchronize()
    one_tps = sum(len(t) for t in same.values()) / (time.perf_counter() - t0)
    system = System.build(spec, models=bundle)
    system.warmup()
    torch.cuda.synchronize()
    rounds = {d: [] for d in range(len(prompts))}
    _reset_launches()
    t0 = time.perf_counter()
    outputs = _drive_sessions(system, prompts, budgets, _round_sink(rounds))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    router = system.engine
    st = router.stats()
    total = sum(len(t) for t in outputs.values())
    print(f"serve {label}: cluster backend, 2 replicas x 4 slots ({kv_dtype} pools), "
          f"8 devices, {total} tokens in {wall:.3f} s ({total / wall:.1f} tokens/s; the "
          f"same sessions on one engine replica {one_tps:.1f}, the 6-device engine serve "
          f"{engine_tps:.1f}), rounds {st.rounds}, migrations {router.migrations}, mean fill "
          f"{st.mean_batch_fill:.2f}, acceptance {st.acceptance_rate:.3f}, launches {launches}",
          flush=True)
    _record_launches(label, records, INT8_PATH if kv_dtype == "int8" else BF16_PATH, launches)
    if router.migrations < 1:
        raise AssertionError(f"{label}: no stream migrated")
    vocab = bundle.target_cfg.vocab_size
    for d, toks in outputs.items():
        if len(toks) != budgets[d] or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{label}: device {d}: bad output {toks}")
    return {"outputs": outputs, "rounds": rounds, "tokens_per_s": total / wall,
            "rounds_total": st.rounds, "migrations": router.migrations,
            "fill": st.mean_batch_fill}


def _wire_checks(label: str, res, total: int) -> None:
    """Lossless links: no straggler timeout, no fallback round, no dropped
    frame; prints wire bytes per committed token and frames."""
    st, cl = res.engine, res.clients
    print(f"serve {label}: wire {st.bytes_tx + st.bytes_rx} bytes "
          f"({(st.bytes_tx + st.bytes_rx) / total:.1f} per committed token), "
          f"frames {st.frames_rx} up / {st.frames_tx} down, pipeline hits "
          f"{cl.pipeline_hits} misses {cl.pipeline_misses}, k_mean {cl.k_mean:.2f}, "
          f"c_th_mean {cl.c_th_mean:.3f}", flush=True)
    bad = {"timeouts": st.timeouts, "fallback_rounds": st.fallback_rounds + cl.fallback_rounds,
           "frames_dropped": st.frames_dropped + cl.frames_dropped}
    if any(bad.values()):
        raise AssertionError(f"{label}: a lossless serve lost rounds: {bad}")


def serve_transport(label: str, records: dict, bundle, prompts, *, spec, engine_tps: float,
                    kits=None, on_event=None) -> dict:
    """The transport backend: asyncio EdgeClients and a TransportServer in
    this process, after System.warmup() (a first verify must not outlast a
    client's verify_timeout)."""
    from repro_torch.api import System

    system = System.build(spec, models=bundle, kits=kits)
    system.warmup()
    torch.cuda.synchronize()
    rounds = {d: [] for d in range(len(prompts))}
    sink = _round_sink(rounds)

    def events(ev):
        sink(ev)
        if on_event is not None:
            on_event(system, ev)

    _reset_launches()
    t0 = time.perf_counter()
    res = system.serve(prompts, on_event=events)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    st = res.engine
    print(f"serve {label}: transport backend ({spec.transport.link} link, "
          f"{spec.cluster.n_replicas} replica(s)), {len(prompts)} devices, {res.total_tokens} "
          f"tokens in {wall:.3f} s ({res.total_tokens / wall:.1f} tokens/s; the engine serve "
          f"of this call {engine_tps:.1f}), rounds {st.rounds}, mean fill "
          f"{st.mean_batch_fill:.2f}, acceptance {st.acceptance_rate:.3f}, launches {launches}",
          flush=True)
    _record_launches(label, records, BF16_PATH, launches)
    _wire_checks(label, res, res.total_tokens)
    vocab = bundle.target_cfg.vocab_size
    for sres in res.sessions:
        if len(sres.tokens) != spec.max_new or not all(0 <= t < vocab for t in sres.tokens):
            raise AssertionError(f"{label}: device {sres.device_id}: bad output {sres.tokens}")
    return {"outputs": res.outputs, "rounds": rounds, "tokens_per_s": res.total_tokens / wall}


def transport_fleet_spec():
    """fleet_spec()'s two classes on the transport backend: 2 replicas, a
    simulated lossless WLAN per device, class-affinity placement (migration
    off: it would move a stream off its class's home), each class drafting
    at its board's rate times 10 (the Raspberry Pi's 3.1 tokens/s becomes
    31, so the throttle adds a second or two), adaptive k and c_th."""
    from repro_torch.api.spec import ClusterSpec, TransportSpec

    spec = fleet_spec()
    return dataclasses.replace(
        spec, backend="transport", kctl="adaptive", cctl="adaptive",
        fleet=dataclasses.replace(spec.fleet, emulate_rates=True, rate_scale=10.0),
        cluster=ClusterSpec(replicas=2, placement="class-affinity", migrate_on_retire=False),
        transport=TransportSpec(link="sim", net="wlan"))


def serve_transport_fleet(records: dict, bundle, prompts, *, engine_tps: float) -> None:
    """The transport fleet: each class equal to its own reference up to near
    ties, each class's streams on its home replica (class i on replica i),
    no round drafting more than its class's k."""
    spec = transport_fleet_spec()
    kits, bundles = fleet_kits(bundle, spec)
    homes, drafted = {}, {}

    def on_event(system, ev):
        from repro_torch.api.events import RoundEvent

        if isinstance(ev, RoundEvent):  # the stream is placed until its Close
            homes.setdefault(ev.device_id, set()).add(system.engine.replica_of(ev.device_id))
            drafted[ev.device_id] = max(drafted.get(ev.device_id, 0), ev.n_drafted)

    served = serve_transport("transport fleet", records, bundle, prompts, spec=spec,
                             engine_tps=engine_tps, kits=kits, on_event=on_event)
    for rc in spec.resolved_classes():
        devs = range(rc.lo, rc.hi)
        on = sorted(set().union(*(homes[d] for d in devs)))
        print(f"transport fleet class {rc.index}: verified on replicas {on}, most tokens "
              f"drafted in a round {max(drafted[d] for d in devs)} (k {rc.k})", flush=True)
        for d in devs:
            if homes[d] != {rc.index}:
                raise AssertionError(f"transport fleet: device {d} of class {rc.index} was "
                                     f"verified on replicas {sorted(homes[d])}")
            if drafted[d] > rc.k:
                raise AssertionError(f"transport fleet: device {d} drafted {drafted[d]} tokens "
                                     f"in a round, more than its class's k {rc.k}")
    check_fleet("transport fleet", bundles, prompts, served, spec=spec)


def _same_streams(label: str, bundle, prompts, got: dict, want: dict, kv_dtype="bf16") -> None:
    """``got`` equals ``want`` device for device, or first departs from it
    at a near tie of the target (a top-2 gap under LOGIT_TOL, printed)."""
    for d, w in want.items():
        p = _first_difference(got[d], w)
        if p is None and len(got[d]) == len(w):
            continue
        if p is None:
            raise AssertionError(f"{label}: device {d}: {len(got[d])} tokens, want {len(w)}")
        gap = _top2_gap(bundle, prompts[d], w[:p], kv_dtype)
        print(f"{label}: device {d} diverges at token {p} ({got[d][p]} against {w[p]}); "
              f"top-2 logit gap {gap:.4g}", flush=True)
        if gap >= LOGIT_TOL:
            raise AssertionError(f"{label}: device {d}: divergence at token {p} with top-2 gap "
                                 f"{gap} >= {LOGIT_TOL}")


def _gpu_compute_mode() -> str:
    """The card's compute mode; worker processes need one that lets several
    processes open a context (not Exclusive_Process)."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card compute mode: {mode}", flush=True)
    if mode == "Exclusive_Process":
        raise AssertionError("the card is in Exclusive_Process mode: worker processes cannot "
                             "open their own contexts")
    return mode


def remote_spec():
    """The cluster phase's fleet: 8 devices, 2 replicas x 4 slots,
    round-robin (each replica a worker process in the remote phase)."""
    from repro_torch.api.spec import ClusterSpec

    return serve_spec("cluster", devices=8,
                      cluster=ClusterSpec(replicas=2, placement="round-robin"))


def worker_main(argv) -> int:
    """Worker mode, ``chip_smoke.py --worker --counts FILE --listen ADDR``:
    the full-width bundle (the parent's weights: the seeded init is
    deterministic), one engine replica of the remote spec on the card, and
    a ReplicaWorker serving it on ADDR. Its kernel launch counters restart
    after each Warmup, and the Drain writes them and the peak device memory
    to FILE."""
    import argparse
    import asyncio

    ap = argparse.ArgumentParser(prog="chip_smoke.py --worker")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--counts", required=True)
    ap.add_argument("--listen", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.api import System
    from repro_torch.transport import codec
    from repro_torch.transport.worker import ReplicaWorker, WorkerCore

    class CountingCore(WorkerCore):
        def handle(self, msg):
            reply = super().handle(msg)
            if isinstance(msg, codec.WarmupRequest):
                torch.cuda.synchronize()
                _reset_launches()
                torch.cuda.reset_peak_memory_stats()
            elif isinstance(msg, codec.Drain):
                torch.cuda.synchronize()
                Path(args.counts).write_text(json.dumps(
                    {"launches": _launches(), "peak_bytes": torch.cuda.max_memory_allocated()}))
            return reply

    spec = remote_spec()
    one = spec.with_backend("engine", scheduler=dataclasses.replace(
        spec.scheduler, slots=spec.slots_per_replica))
    engine = System.build(one, models=full_width_bundle("qwen2-1.5b")).engine
    worker = ReplicaWorker(args.listen, engine=engine)
    worker.core = CountingCore(engine)
    asyncio.run(worker.serve())
    return 0


def serve_remote(records: dict, bundle, prompts, *, cluster: dict) -> dict:
    """The cluster phase's 8 sessions on 2 worker processes of 4 slots each,
    every worker this script in worker mode holding the full-width model on
    the card, behind a Router of RemoteReplicas (round-robin, migration on
    retire). Streams equal to the in-process cluster phase's (``cluster``)
    up to near ties; >= 1 migration across processes; the paged bf16
    kernel launched in each worker. The workers are drained and reaped in
    a ``finally``, so none outlives a failing run."""
    import tempfile

    from repro_torch.api import System
    from repro_torch.cluster.remote import RemoteReplica, kill_worker_proc, spawn_worker
    from repro_torch.cluster.router import Router

    _gpu_compute_mode()
    torch.cuda.empty_cache()  # earlier phases' cached blocks go back to the card
    spec = remote_spec()
    budgets = [8 if i % 2 == 0 else 32 for i in range(len(prompts))]
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-remote-"))
    counts = [tmp / f"worker{i}.json" for i in range(spec.cluster.n_replicas)]
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(counts)) as pool:
        futures = [pool.submit(spawn_worker, cmd=[*cmd, "--counts", str(c)],
                               startup_timeout=600.0) for c in counts]
        spawned = [f.exception() or f.result() for f in futures]
    remotes = []
    try:
        for item in spawned:
            if isinstance(item, BaseException):
                raise item
        print(f"serve remote: {len(spawned)} workers up in {time.perf_counter() - t0:.2f} s",
              flush=True)
        for proc, addr in spawned:
            r = RemoteReplica.dial(addr, timeout=600.0)
            r.proc, r.spawned = proc, True
            r.adopt(n_slots=spec.slots_per_replica, k_max=spec.k_max, max_len=spec.max_len,
                    greedy=spec.greedy)
            remotes.append(r)
        router = Router(remotes, placement=spec.cluster.placement,
                        migrate_on_retire=spec.cluster.migrate_on_retire)
        kit = System.build(spec.with_backend("reference"), models=bundle).kit
        system = System(spec, bundle, router, kit,
                        torch.device("cuda", torch.cuda.current_device()))
        t0 = time.perf_counter()
        system.warmup()
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        rounds = {d: [] for d in range(len(prompts))}
        rpc_s = [-r.channel.seconds for r in remotes]
        _reset_launches()
        t0 = time.perf_counter()
        outputs = _drive_sessions(system, prompts, budgets, _round_sink(rounds))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        parent = _launches()
        rpc_s = [s + r.channel.seconds for s, r in zip(rpc_s, remotes)]  # the serve's RPCs
        per_worker = router.replica_stats()
        st = router.stats()
        wire = {k: sum(getattr(r.channel, k) for r in remotes)
                for k in ("bytes_tx", "bytes_rx", "frames_tx", "frames_rx")}
        migrations = router.migrations
    finally:
        for r in remotes:
            r.drain()
        for item in spawned:
            if not isinstance(item, BaseException):
                kill_worker_proc(item[0])
    workers = [json.loads(c.read_text()) for c in counts]
    total = sum(len(t) for t in outputs.values())
    print(f"serve remote: cluster backend, 2 worker processes x 4 slots (bf16 pools), "
          f"8 devices, {total} tokens in {wall:.3f} s ({total / wall:.1f} tokens/s; the "
          f"in-process cluster of this call {cluster['tokens_per_s']:.1f}, rounds "
          f"{cluster['rounds_total']}, migrations {cluster['migrations']}, fill "
          f"{cluster['fill']:.2f}), rounds {st.rounds}, migrations {migrations}, mean fill "
          f"{st.mean_batch_fill:.2f}, acceptance {st.acceptance_rate:.3f}, warmup "
          f"{warm_s:.2f} s", flush=True)
    print(f"serve remote: control channels {wire['bytes_tx']} bytes / {wire['frames_tx']} "
          f"frames out, {wire['bytes_rx']} bytes / {wire['frames_rx']} frames in; parent "
          f"launches {parent}", flush=True)
    for i, w in enumerate(workers):
        ws = per_worker[i]
        verify_s = ws.server_busy_frac * ws.rounds / max(ws.server_rounds_per_s, 1e-9)
        print(f"serve remote: worker {i} peak device memory {w['peak_bytes'] / 2**30:.2f} GiB, "
              f"{ws.rounds} rounds, verify steps {verify_s:.3f} s, the parent's time in its "
              f"RPCs of the serve {rpc_s[i]:.3f} s, launches {w['launches']}", flush=True)
        if w["launches"]["verify_attention_paged"] <= 0:
            raise AssertionError(f"remote: worker {i} never launched the paged bf16 kernel")
    combined = {n: parent[n] + sum(w["launches"][n] for w in workers) for n in parent}
    _record_launches("remote", records, BF16_PATH, combined)
    if migrations < 1:
        raise AssertionError("remote: no stream migrated between the worker processes")
    _same_streams("remote", bundle, prompts, outputs, cluster["outputs"])
    print("serve remote: streams == the in-process cluster's on 8 devices (up to the "
          "divergences printed above)", flush=True)
    return {"outputs": outputs, "rounds": rounds, "tokens_per_s": total / wall}


def serve_remote_spawned() -> None:
    """The front door: System.build of examples/specs/cluster_remote.json
    (2 remote replicas) spawns and places two ``python -m
    repro_torch.transport.worker`` processes on the card, on the cluster
    and the transport backends. Each serve equals the in-process cluster of
    build_models(spec.model) up to near ties; after close() no worker
    process and no socket directory is left. The spec's reduced qwen2 has
    head_dim 16, which the attention kernel does not take (64 or 128), so
    the spec is served with its model's family swapped for mamba2-370m,
    whose reduced shapes (P 16, N 16, chunk 16) the SSD scan kernel takes;
    the deployment (replicas, slots, placement, devices, budgets) is the
    spec's."""
    import os

    from repro_torch.api import ServeSpec, System, build_models
    from repro_torch.cluster.remote import worker_sock_dir

    _gpu_compute_mode()
    spec = ServeSpec.from_json((Path(__file__).resolve().parent / "examples" / "specs"
                                / "cluster_remote.json").read_text())
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, arch="mamba2-370m", draft_arch="mamba2-370m"))
    models = build_models(spec.model)
    inproc = System.build(dataclasses.replace(spec, cluster=dataclasses.replace(
        spec.cluster, replicas=spec.cluster.n_replicas)), models=models)
    prompts = inproc.prompts()
    want = inproc.serve(prompts).outputs
    for backend in ("cluster", "transport"):
        t0 = time.perf_counter()
        system = System.build(dataclasses.replace(spec, backend=backend))
        procs = dirs = []
        try:
            procs = [r.proc for r in system.engine.replicas]
            dirs = [worker_sock_dir(r.address) for r in system.engine.replicas]
            up_s = time.perf_counter() - t0
            system.warmup()
            t0 = time.perf_counter()
            res = system.serve(prompts)
            wall = time.perf_counter() - t0
        finally:
            system.close()
        print(f"serve remote spawned: {backend} backend, {len(procs)} spawned workers "
              f"(build and place {up_s:.2f} s), {res.total_tokens} tokens in {wall:.3f} s, "
              f"rounds {res.engine.rounds}, migrations {system.engine.migrations}", flush=True)
        left = [p.pid for p in procs if p.poll() is None] + [d for d in dirs if os.path.exists(d)]
        if len(procs) != 2 or None in dirs or left:
            raise AssertionError(f"remote spawned {backend}: after close(): {left or dirs}")
        _same_streams(f"remote spawned {backend}", models, prompts, res.outputs, want)


# the Router step at which the remote chaos phase kills worker 1: after two
# verify rounds, before any stream of worker 1 retires or migrates (its 4
# streams are the odd ids, budget 32)
CHAOS_KILL_STEP = 3


def _spawn_counting_worker(counts: Path):
    """This script in worker mode on the card, its counts going to ``counts``:
    ``(proc, address)``."""
    from repro_torch.cluster.remote import spawn_worker

    return spawn_worker(cmd=[sys.executable, str(Path(__file__).resolve()), "--worker",
                             "--counts", str(counts)], startup_timeout=600.0)


def serve_remote_chaos(records: dict, bundle, prompts, *, cluster: dict, remote: dict) -> None:
    """The remote phase's 8 sessions on 2 worker processes (full-width
    qwen2-1.5b, bf16 pools, budgets 8 and 32, round-robin, migration on
    retire) under FaultPolicy(respawn, recover_streams, backoff 0.05-0.5 s):
    worker 1 is SIGKILLed at Router step CHAOS_KILL_STEP, where it must
    hold at least 2 running streams with committed tokens. Its revive goes
    through a channel_factory that starts a fresh worker with its own
    counts file. Must hold: 1 eviction, 1 respawn, nothing shed, every
    stream of worker 1 at the kill recovered, the streams equal to the
    in-process cluster phase's (``cluster``) up to near ties, and the
    revived worker's counts showing the dense (replayed prefill) and paged
    (replayed force_extend runs, verify) bf16 kernels. Every worker is
    drained and reaped in a ``finally``."""
    import tempfile

    from repro_torch.api import System
    from repro_torch.api.spec import FaultPolicy, FaultSpec
    from repro_torch.cluster.faults import ChaosInjector
    from repro_torch.cluster.remote import ControlChannel, RemoteReplica, kill_worker_proc
    from repro_torch.cluster.router import Router

    _gpu_compute_mode()
    torch.cuda.empty_cache()
    spec = remote_spec()
    policy = FaultPolicy(respawn=True, recover_streams=True, backoff_base_s=0.05,
                         backoff_max_s=0.5)
    budgets = [8 if i % 2 == 0 else 32 for i in range(len(prompts))]
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-chaos-"))
    counts = [tmp / f"worker{i}.json" for i in range(spec.cluster.n_replicas)]
    revived_counts = tmp / "worker1-revived.json"
    shape = dict(n_slots=spec.slots_per_replica, k_max=spec.k_max, max_len=spec.max_len,
                 greedy=spec.greedy)
    procs, remotes, timing = [], [], {}
    try:
        with ThreadPoolExecutor(len(counts)) as pool:
            spawned = list(pool.map(_spawn_counting_worker, counts))
        for proc, addr in spawned:
            procs.append(proc)
            r = RemoteReplica.dial(addr, timeout=600.0)
            r.proc, r.spawned, r.retry_rpcs = proc, True, policy.retry_rpcs
            r.adopt(**shape)
            remotes.append(r)

        def respawn() -> ControlChannel:
            t0 = time.perf_counter()
            proc, addr = _spawn_counting_worker(revived_counts)
            procs.append(proc)
            t1 = time.perf_counter()
            channel = ControlChannel(addr, timeout=600.0)
            channel.connect()
            timing.update(spawn_s=t1 - t0, dial_s=time.perf_counter() - t1)
            return channel

        remotes[1].channel_factory = respawn
        router = Router(remotes, placement=spec.cluster.placement,
                        migrate_on_retire=spec.cluster.migrate_on_retire, faults=policy)
        router.chaos = ChaosInjector(FaultSpec(events=(
            {"kind": "kill", "replica": 1, "round": CHAOS_KILL_STEP},)), router)
        at_kill: dict = {}
        kill, readmit = remotes[1].chaos_kill, router._readmit

        def recorded_kill():
            at_kill.update(step=router.steps_taken, t=time.perf_counter(), committed={
                d: len(router._committed.get(d, ())) for d in remotes[1].streams})
            kill()

        def timed_readmit(dev):  # router_recovery_seconds' span: the replays
            t0 = time.perf_counter()
            try:
                return readmit(dev)
            finally:
                timing["recovery_s"] = timing.get("recovery_s", 0.0) + time.perf_counter() - t0

        remotes[1].chaos_kill, router._readmit = recorded_kill, timed_readmit
        kit = System.build(spec.with_backend("reference"), models=bundle).kit
        system = System(spec, bundle, router, kit,
                        torch.device("cuda", torch.cuda.current_device()))
        system.warmup()
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        outputs = _drive_sessions(system, prompts, budgets, lambda ev: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        parent = _launches()
        longest = max(r.channel.longest_s for r in remotes)
    finally:
        for r in remotes:
            r.drain()
        for proc in procs:
            kill_worker_proc(proc)
    workers = [json.loads(c.read_text()) for c in (counts[0], revived_counts)]
    total = sum(len(t) for t in outputs.values())
    replayed = sum(at_kill.get("committed", {}).values())
    print(f"serve remote chaos: worker 1 SIGKILLed at Router step {at_kill.get('step')} holding "
          f"streams {sorted(at_kill.get('committed', {}))} with {replayed} committed tokens; "
          f"evictions {router.evictions}, respawns {router.respawns}, recovered "
          f"{router.recovered_streams}, shed {router.shed_streams}; respawn: spawn "
          f"{timing.get('spawn_s', 0.0):.2f} s, dial {timing.get('dial_s', 0.0):.3f} s (shape "
          f"adopted, no placement); recovery (device replay, router_recovery_seconds' span) "
          f"{timing.get('recovery_s', 0.0):.3f} s, {replayed} tokens replayed in force_extend "
          f"runs of <= {spec.k_max + 1} after 200-token prefills; flight dump of worker 1 "
          f"{len(router.flight_dumps.get(1, []))} rounds; longest RPC {longest:.3f} s",
          flush=True)
    print(f"serve remote chaos: {total} tokens in {wall:.3f} s ({total / wall:.1f} tokens/s; "
          f"the fault-free serve remote of this call {remote['tokens_per_s']:.1f}), "
          f"migrations {router.migrations}; parent launches {parent}, worker 0 "
          f"{workers[0]['launches']}, revived worker 1 {workers[1]['launches']}", flush=True)
    streams_at_kill = at_kill.get("committed", {})
    if at_kill.get("step") != CHAOS_KILL_STEP or sum(n > 0 for n in streams_at_kill.values()) < 2:
        raise AssertionError(f"remote chaos: at the kill worker 1 held {streams_at_kill}; "
                             "it must hold >= 2 streams with committed tokens")
    counters = (router.evictions, router.respawns, router.shed_streams)
    if counters != (1, 1, 0) or router.recovered_streams != len(streams_at_kill):
        raise AssertionError(f"remote chaos: evictions, respawns, shed {counters}, recovered "
                             f"{router.recovered_streams} of {len(streams_at_kill)}")
    revived = workers[1]["launches"]
    if revived["verify_attention_packed"] <= 0 or revived["verify_attention_paged"] <= 0:
        raise AssertionError(f"remote chaos: the revived worker launched {revived}")
    combined = {n: parent[n] + sum(w["launches"][n] for w in workers) for n in parent}
    _record_launches("remote chaos", records, BF16_PATH, combined)
    for d, toks in outputs.items():
        if len(toks) != budgets[d]:
            raise AssertionError(f"remote chaos: device {d}: {len(toks)} tokens")
    _same_streams("remote chaos", bundle, prompts, outputs, cluster["outputs"])
    print("serve remote chaos: streams == the in-process cluster's on 8 devices (up to the "
          "divergences printed above)", flush=True)


def _chaos_run(label: str, spec, prompts) -> tuple:
    """System.build of ``spec`` (remote replicas it spawns) and one serve;
    the result, the Router and the seconds from each fault firing to the
    eviction that followed. After close() no worker process or socket
    directory may be left."""
    import os

    from repro_torch.api import System
    from repro_torch.cluster.remote import worker_sock_dir

    t0 = time.perf_counter()
    procs, dirs, fired, to_evict = [], [], {}, []
    with System.build(spec) as system:
        router = system.engine
        for r in router.replicas:
            for kind in ("kill", "hang"):
                act = getattr(r, f"chaos_{kind}")

                def timed(act=act):
                    fired["t"] = time.perf_counter()
                    act()

                setattr(r, f"chaos_{kind}", timed)
        evict = router._evict

        def timed_evict(i):
            if "t" in fired and not router.replicas[i].dead:
                to_evict.append(time.perf_counter() - fired["t"])
            evict(i)

        router._evict = timed_evict
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = system.serve(prompts)
        wall = time.perf_counter() - t0
        procs = [r.proc for r in router.replicas]
        dirs = [worker_sock_dir(r.address) for r in router.replicas]
        longest = max(r.channel.longest_s for r in router.replicas)
    left = [p.pid for p in procs if p.poll() is None] + [d for d in dirs if os.path.exists(d)]
    print(f"serve chaos spawned {label}: build and place {up_s:.2f} s, {res.total_tokens} "
          f"tokens in {wall:.3f} s, fired {router.chaos.fired}, evictions {router.evictions}, "
          f"respawns {router.respawns}, recovered {router.recovered_streams}, shed "
          f"{router.shed_streams} {res.lost_devices}, retried RPCs "
          f"{sum(r.retries for r in router.replicas)}, seconds from fault to eviction "
          f"{[round(x, 3) for x in to_evict]}, longest RPC {longest:.3f} s", flush=True)
    if None in dirs or left:
        raise AssertionError(f"chaos spawned {label}: after close(): {left or dirs}")
    return res, router


def serve_chaos_spawned(records: dict) -> None:
    """examples/specs/chaos.json with its own model (reduced qwen2, head_dim
    16: the attention kernel's D = 16 instantiation) on 2 spawned workers
    (``{"flavor": "remote"}``), four runs, each held to the fault-free
    in-process serve of the same spec (weights rebuilt from the spec's
    seed in every process):
      1. the spec's kill of replica 1 at round 5 with respawn and recovery:
         1 eviction, 1 respawn, nothing shed, the fault-free streams (a
         near tie printed if any);
      2. a hang (SIGSTOP) of replica 1 at round 5 with heartbeats every
         0.2 s (3 misses of 1 s) and a 2 s RPC timeout: evicted and
         revived, nothing shed, the seconds to eviction printed;
      3. a flap of replica 1 at round 5, through ``python -m
         repro_torch.launch.chaos --spec ... --check``: retried RPCs >= 1,
         no eviction, its check passing, the fault-free streams;
      4. the kill under the default FaultPolicy: the lost sessions end
         ``shed=True`` with prefixes of their fault-free streams, the
         others complete, and the serve returns."""
    import tempfile

    from repro_torch.api import ServeSpec, System, build_models
    from repro_torch.api.spec import FaultPolicy, FaultSpec
    from repro_torch.launch import chaos as chaos_cli

    _gpu_compute_mode()
    spec = ServeSpec.from_json((Path(__file__).resolve().parent / "examples" / "specs"
                                / "chaos.json").read_text())
    models = build_models(spec.model)
    inproc = System.build(dataclasses.replace(spec, faults=FaultSpec()), models=models)
    prompts = inproc.prompts()
    _reset_launches()
    want = inproc.serve(prompts).outputs
    _record_launches("chaos in-process", records, BF16_PATH, _launches())
    remote = dataclasses.replace(spec, cluster=dataclasses.replace(
        spec.cluster, replicas=[{"flavor": "remote"}] * spec.cluster.n_replicas))
    at5 = {"replica": 1, "round": 5}

    def with_faults(policy, kind):
        return dataclasses.replace(
            remote, cluster=dataclasses.replace(remote.cluster, faults=policy),
            faults=FaultSpec(events=({"kind": kind, **at5},)))

    def same(label, res) -> None:
        same_all = res.outputs == want
        print(f"serve chaos spawned {label}: streams identical to the fault-free in-process "
              f"serve: {same_all}", flush=True)
        if not same_all:
            _same_streams(f"chaos spawned {label}", models, prompts, res.outputs, want)

    _reset_launches()
    res, router = _chaos_run("kill", remote, prompts)
    if (router.evictions, router.respawns, router.shed_streams, res.lost_devices) != (1, 1, 0, []):
        raise AssertionError("chaos spawned kill: supervision did not recover every stream")
    same("kill", res)
    hang_policy = dataclasses.replace(spec.cluster.faults, heartbeat_interval_s=0.2,
                                      heartbeat_timeout_s=1.0, heartbeat_misses=3,
                                      rpc_timeout_s=2.0)
    res, router = _chaos_run("hang", with_faults(hang_policy, "hang"), prompts)
    if (router.evictions, router.respawns, router.shed_streams) != (1, 1, 0):
        raise AssertionError("chaos spawned hang: the hung worker was not evicted and revived")
    same("hang", res)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-flap-") as tmp:
        spec_path, out_path = Path(tmp) / "flap.json", Path(tmp) / "flap-record.json"
        spec_path.write_text(with_faults(spec.cluster.faults, "flap").to_json_str())
        rc = chaos_cli.main(["--spec", str(spec_path), "--check", "--json", str(out_path)])
        record = json.loads(out_path.read_text())
    report = record["chaos"]
    got = {s["device_id"]: s["tokens"] for s in record["result"]["sessions"]}
    print(f"serve chaos spawned flap (repro_torch.launch.chaos): rc {rc}, {report}", flush=True)
    if rc != 0 or report["retries"] < 1 or report["evictions"] != 0:
        raise AssertionError("chaos spawned flap: the retried RPCs did not absorb the flap")
    if got != want:
        _same_streams("chaos spawned flap", models, prompts, got, want)
    res, router = _chaos_run("kill, default policy", with_faults(FaultPolicy(), "kill"), prompts)
    launches = _launches()
    shed = {s.device_id for s in res.sessions if s.shed}
    if router.respawns or not res.lost_devices or shed != set(res.lost_devices):
        raise AssertionError(f"chaos spawned default policy: lost {res.lost_devices}, shed {shed}")
    for s in res.sessions:
        w = want[s.device_id]
        if (s.tokens != w[:len(s.tokens)]) if s.shed else (s.tokens != w):
            raise AssertionError(f"chaos spawned default policy: device {s.device_id}: "
                                 f"{s.tokens} against the fault-free {w} (shed {s.shed})")
    print(f"serve chaos spawned kill, default policy: sessions {sorted(shed)} ended shed with "
          f"their fault-free prefixes, the others complete; the parent's draft launches over "
          f"the four runs {launches}", flush=True)
    _record_launches("chaos spawned (parent drafts)", records,
                     {"verify_attention_packed": None}, launches)


class _MoeTally:
    """The moe tally's (assignments, dropped) of a serve, split by what ran:
    the target's prefills, its verifies (and replays), and the drafts'
    prefills and steps. Each wrapped call snapshots the card's running
    tally (models.layers.moe_tally) and adds the difference after it, on
    the card: no host sync."""

    KINDS = ("prefill", "verify", "draft")

    def __init__(self):
        self.counts = {k: torch.zeros(2, dtype=torch.int64, device="cuda") for k in self.KINDS}

    def reset(self) -> None:
        for c in self.counts.values():
            c.zero_()

    def _wrap(self, fn, kind: str):
        from repro_torch.models.layers import moe_tally

        def run(*args, **kw):
            tally = moe_tally("cuda")
            before = tally.clone()
            out = fn(*args, **kw)
            self.counts[kind] += tally - before
            return out
        return run

    def bundle(self, bundle):
        """``bundle`` with its models' prefill and decode_forward tallied."""
        t, d = bundle.target, bundle.draft
        return dataclasses.replace(
            bundle,
            target=dataclasses.replace(t, prefill=self._wrap(t.prefill, "prefill"),
                                       decode_forward=self._wrap(t.decode_forward, "verify")),
            draft=dataclasses.replace(d, prefill=self._wrap(d.prefill, "draft"),
                                      decode_forward=self._wrap(d.decode_forward, "draft")))

    def read(self) -> dict:
        """kind -> (assignments, dropped)."""
        return {k: tuple(int(x) for x in c.tolist()) for k, c in self.counts.items()}

    def line(self) -> str:
        return ", ".join(f"{k} {d}/{a} ({d / max(a, 1):.4f})" for k, (a, d) in self.read().items())


def serve_moe(label: str, records: dict, bundle, prompts, *, max_new: int) -> dict:
    """The moe fleet as registered (capacity_factor 1.25) on the engine
    backend, twice: every token in the vocabulary (serve()), every logit of
    the target and the draft finite, and the second serve's tokens equal
    to the first's. The capacity dispatch makes a stream depend on the rows
    batched with it, and the engine batches them otherwise than the
    reference does, so this serve is held by determinism; check_moe holds
    the dropless twin to the reference. Prints the tally as dropped /
    assigned for prefills, verifies and draft steps."""
    arch = bundle.target_cfg.name
    runs = []
    for run in range(2):
        tally, target_watch, draft_watch = _MoeTally(), _FiniteWatch(), _FiniteWatch()
        b = tally.bundle(bundle)
        b = dataclasses.replace(b, target=target_watch.wrap(b.target),
                                draft=draft_watch.wrap(b.draft))
        torch.cuda.reset_peak_memory_stats()
        served = serve(label if run == 0 else f"{label} again", records, b, prompts,
                       spec=serve_spec("engine", arch, max_new=max_new), path=BF16_PATH,
                       need_accepted=False, tally=tally)
        if not (bool(target_watch.ok) and bool(draft_watch.ok)):
            raise AssertionError(f"{label}: a logit was not finite (target ok "
                                 f"{bool(target_watch.ok)}, draft ok {bool(draft_watch.ok)})")
        print(f"serve {label}: dropped/assigned {tally.line()}", flush=True)
        runs.append(served)
    if runs[0]["outputs"] != runs[1]["outputs"]:
        raise AssertionError(f"{label}: a second serve of the same fleet gave other tokens: "
                             f"{runs[0]['outputs']} then {runs[1]['outputs']}")
    print(f"serve {label}: the second serve gave the same {len(prompts)} streams, token for "
          "token", flush=True)
    return runs[0]


def dropless_twin(bundle):
    """The same weights under configs whose capacity_factor is E / K, so
    every expert has a slot for every token of a call and nothing drops."""
    from repro_torch.models.model_zoo import build_model

    def twin(cfg):
        return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)

    tcfg, dcfg = twin(bundle.target_cfg), twin(bundle.draft_cfg)
    return dataclasses.replace(bundle, target_cfg=tcfg, draft_cfg=dcfg, target=build_model(tcfg),
                               draft=build_model(dcfg))


def check_moe(label: str, records: dict, bundle, prompts, *, max_new: int) -> None:
    """The dropless twin served by the engine and by the reference backend:
    the tally must show nothing dropped in either (the reference's count
    includes check()'s gap prefills and replays), and the engine's streams
    must equal the reference's up to near ties or pass the replay witness
    (check(), witness=True): with nothing dropped a row's output depends on
    its own tokens only, so the witness may repeat a stream's row."""
    arch = bundle.target_cfg.name
    twin = dropless_twin(bundle)
    tally = _MoeTally()
    served = serve(f"{label} dropless", records, tally.bundle(twin), prompts,
                   spec=serve_spec("engine", arch, max_new=max_new), path=BF16_PATH,
                   need_accepted=False, tally=tally)
    print(f"check {label}: dropless engine serve, dropped/assigned {tally.line()}", flush=True)
    ref_tally = _MoeTally()
    check(label, ref_tally.bundle(twin), prompts, served,
          spec=serve_spec("reference", arch, max_new=max_new), witness=True)
    print(f"check {label}: reference and witnesses, dropped/assigned {ref_tally.line()}",
          flush=True)
    for which, t in (("engine", tally), ("reference", ref_tally)):
        counts = t.read()
        if any(d for _, d in counts.values()) or not all(a for a, _ in counts.values()):
            raise AssertionError(f"{label}: the dropless {which} serve's tally is {counts}")


def calibrate_moe(bundle) -> dict:
    """The moe target's verify step on an engine of 8 slots (buckets 1, 2,
    4, 8), timed as calibrate_h100 times the 11B's, beside two bounds: the
    bytes of every weight, which the capacity dispatch reads on every call
    (every expert's tables, whatever the routing), and the bytes of one
    token's active parameters (K of the E experts). A step under the first
    bound fails: the timing did not wait for the card."""
    from repro_torch.api import System
    from repro_torch.api.spec import SchedulerSpec

    cfg = bundle.target_cfg
    spec = serve_spec("engine", cfg.name, max_new=16, scheduler=SchedulerSpec(slots=8))
    system = System.build(spec, models=bundle)
    system.warmup()
    runs = [system.warmup() for _ in range(5)]
    every = _verify_bytes(bundle.target_params)
    experts = sum(p.numel() * p.element_size()
                  for name, p in bundle.target_params.named_parameters() if ".moe.w" in name)
    active = every - experts * (1 - cfg.experts_per_token / cfg.num_experts)
    out = {}
    for b in sorted(runs[0]):
        t = sorted(r[b] for r in runs)[2]
        out[b] = t
        print(f"calibrate {cfg.name}: bucket {b}: verify step {t * 1e3:.3f} ms (of 5: "
              f"{[round(r[b] * 1e3, 3) for r in runs]}), every weight {every} bytes: bound "
              f"{every / HBM_BYTES_PER_S * 1e3:.3f} ms; active parameters {int(active)} bytes: "
              f"bound {active / HBM_BYTES_PER_S * 1e3:.3f} ms", flush=True)
        if t < every / HBM_BYTES_PER_S:
            raise AssertionError(f"calibrate {cfg.name}: bucket {b} step {t} s is under the "
                                 "bound of the weights it reads: the timing did not wait")
    return out


def paper_pair_bundle():
    """The paper's pair at its published widths (configs/sled_paper.py):
    llama-11b-target (40 layers, d_model 4096, 32 query heads on 8 KV heads
    of 128, d_ff 14336, vocab 128256, an untied head) verifying
    llama-1b-draft (16 layers, d_model 2048, heads of 64, a tied head),
    each with its own seeded init on the card and its output projections
    scaled by RESID_SCALE as in full_width_bundle. init_params draws one
    tensor at a time, so the f32 temporaries stay one tensor's size."""
    from repro_torch.api import ModelBundle
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    models = []
    for seed, arch in enumerate(("llama-11b-target", "llama-1b-draft")):
        cfg = get_config(arch)
        model = build_model(cfg)
        params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
        with torch.no_grad():
            for blk in params.layers:
                blk.attn.wo.mul_(RESID_SCALE)
                blk.mlp.wd.mul_(RESID_SCALE)
        n = sum(p.numel() for p in params.parameters())
        print(f"init {arch}: {n} parameters ({cfg.param_count()} by the config), tied head "
              f"{cfg.tie_embeddings}", flush=True)
        models.append((cfg, model, params))
    (tcfg, target, tp), (dcfg, draft, dp) = models
    torch.cuda.synchronize()
    print(f"init llama pair: device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return ModelBundle(tcfg, dcfg, target, draft, tp, dp)


def paper_spec(backend: str, **changes):
    return serve_spec(backend, "llama-11b-target", draft_arch="llama-1b-draft", **changes)


def _verify_bytes(params) -> int:
    """The weight bytes one verify step must read: every layer's weights and
    the final norm once, and the f32 head that lm_head streams (head_f32;
    the bf16 table it was widened from is not read). The embedding rows
    the step looks up are left out (B x 5 rows of d_model)."""
    n = sum(p.numel() * p.element_size() for name, p in params.named_parameters()
            if name not in ("embed", "lm_head_w"))
    head = params.head_f32()
    return n + head.numel() * head.element_size()


def calibrate_h100(bundle) -> dict:
    """The verify step of the full-width 11B on an engine of 8 slots
    (buckets 1, 2, 4, 8): one warm step, then the median of 5, each ending
    in a host read of the step's output (EngineCore.warmup). Each beside
    the weight-stream bound and the H100 profile's verify_latency; a step
    under its bound means the timing did not wait for the card. Prints the
    profile's launch overhead as measured here: the B = 1 step less the
    profile's memory term at the config's param_count() (not the tuner's
    nominal 11e9)."""
    from repro_torch.api import System
    from repro_torch.api.spec import SchedulerSpec
    from repro_torch.serving.devices import H100

    spec = paper_spec("engine", scheduler=SchedulerSpec(slots=8))
    system = System.build(spec, models=bundle)
    system.warmup()
    runs = [system.warmup() for _ in range(5)]
    nbytes = _verify_bytes(bundle.target_params)
    bound_s = nbytes / HBM_BYTES_PER_S
    params = bundle.target_cfg.param_count()
    out = {}
    for b in sorted(runs[0]):
        t = sorted(r[b] for r in runs)[2]
        pred = H100.verify_latency(params, b, spec.k_max + 1)
        out[b] = t
        print(f"calibrate h100: bucket {b}: verify step {t * 1e3:.3f} ms (of 5: "
              f"{[round(r[b] * 1e3, 3) for r in runs]}), weight-stream bound "
              f"{bound_s * 1e3:.3f} ms ({nbytes} bytes), profile verify_latency "
              f"{pred * 1e3:.3f} ms", flush=True)
        if t < bound_s:
            raise AssertionError(f"calibrate h100: bucket {b} step {t} s is under its "
                                 f"weight-stream bound {bound_s} s: the timing did not wait")
    mem = H100.verify_latency(params, 1, spec.k_max + 1) - H100.launch_overhead_s
    print(f"calibrate h100: launch_overhead_s {out[1] - mem:.6f} (B = 1 step {out[1]:.6f} s "
          f"less the profile's memory term {mem:.6f} s at param_count() {params}); the "
          f"profile in serving/devices.py holds {H100.launch_overhead_s}", flush=True)
    return out


def _sim_fig4_run(job):
    """One simulation of sim_fig4: (target, batch, mode) -> its result's
    WSTGR and server busy share."""
    from repro_torch.serving.devices import H100, RPI5
    from repro_torch.serving.simulator import SimConfig, simulate

    target_p, b, mode = job
    res = simulate(SimConfig(mode=mode, spec_len=4, acceptance=0.90,
                             device_rate=RPI5.rate("llama-3b-draft", 4), target_params=target_p,
                             server_batch=b, batch_policy="deadline", n_devices=64 * b,
                             sim_time=10.0), H100)
    return res.wstgr, res.server_busy_frac


SIM_FIG4_ROWS = [(target_p, tname, b) for target_p, tname in ((11e9, "11B"), (70e9, "70B"))
                 for b in (2, 8, 32)]


def start_sim_fig4():
    """Start sim_fig4's 12 simulations (host Python, no device) in 12
    processes, to run beside the device phases; ``sim_fig4`` reads them.
    The longest (70B, batch 32, SLED) takes ~90 s of one core."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    jobs = [(target_p, b, mode) for target_p, _, b in SIM_FIG4_ROWS
            for mode in ("sled", "centralized")]
    pool = ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn"))
    return pool, {job: pool.submit(_sim_fig4_run, job) for job in jobs}


def sim_fig4(started) -> None:
    """The simulator on the H100 profile in the setting of the JAX package's
    benchmarks/wstgr.py run(quick=True) (paper Fig. 4): SLED against
    centralized, 11B and 70B, batch 2, 8 and 32, RPi 5 drafting with the
    int4 3B draft, acceptance 0.90, 64 x batch devices, 10 s. A prediction
    of this card's profile, not a measurement; no bound. ``started`` is
    ``start_sim_fig4()``'s pool and futures; its processes end here."""
    pool, futures = started
    try:
        results = {job: fut.result(timeout=600) for job, fut in futures.items()}
    finally:
        pool.shutdown(cancel_futures=True)
    for target_p, tname, b in SIM_FIG4_ROWS:
        sled, sled_busy = results[(target_p, b, "sled")]
        cent, _ = results[(target_p, b, "centralized")]
        print("sim fig4 (prediction, h100 profile) " + json.dumps({
            "target": tname, "batch": b, "wstgr_sled": round(sled, 1),
            "wstgr_centralized": round(cent, 1), "ratio": round(sled / max(cent, 1e-9), 2),
            "sled_busy": round(sled_busy, 2)}), flush=True)


def tune_on_card(records: dict) -> None:
    """repro_torch.tuning.tune of examples/specs/fleet.json (the reduced
    qwen2, head_dim 16) on the card with the H100 profile, at the settings
    of the JAX package's tests/test_fleet.py::test_tune_quick_emits_valid_
    winner; the winner must round-trip through JSON and serve on the card.
    Then the CLI once, in its own process."""
    import os
    import tempfile

    from repro_torch.api import ServeSpec, System
    from repro_torch.tuning import TuneConfig, tune

    spec_path = Path(__file__).resolve().parent / "examples" / "specs" / "fleet.json"
    spec = ServeSpec.from_json(spec_path.read_text())
    t0 = time.perf_counter()
    _reset_launches()
    res = tune(spec, TuneConfig(server="h100", quick=True, n_validate=1, sim_time=4.0, passes=1),
               device="cuda")
    launches = _launches()
    cal = res.calibration
    print(f"tune: calibration server_latency_scale {cal.server_latency_scale:.4g}, "
          f"verify_s_mean {cal.verify_s_mean:.6f} s, per-class acceptance "
          f"{[round(c.acceptance, 3) for c in cal.classes]}, deadline {res.deadline_s} s, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if cal.server_latency_scale <= 0:
        raise AssertionError("tune: the profiled serve measured no verify span")
    winner = ServeSpec.from_json(res.winner.to_json_str())
    winner.validate()
    if winner != res.winner:
        raise AssertionError("tune: the winner does not round-trip through JSON")
    print("tune: winner " + json.dumps([
        {"profile": rc.spec.profile, "k": rc.k, "c_th": rc.c_th, "bits": rc.spec.bits}
        for rc in winner.resolved_classes()]), flush=True)
    _record_launches("tune", records, {"verify_attention_packed": None,
                                       "verify_attention_paged": None}, launches)
    with System.build(winner) as system:
        out = system.serve()
    if sorted(out.outputs) != list(range(winner.devices)) or not all(
            len(t) == winner.max_new for t in out.outputs.values()):
        raise AssertionError(f"tune: the winner's serve gave {out.outputs}")
    print(f"tune: the winner serves {out.total_tokens} tokens on the card "
          f"({out.engine.rounds} rounds)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        dest = Path(tmp) / "tuned.json"
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.tune", "--spec", str(spec_path),
             "--quick", "--server", "h100", "--device", "cuda", "--out", str(dest)],
            capture_output=True, text=True, timeout=400,
            env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")})
        tail = cli.stdout.strip().splitlines()[-3:]
        if cli.returncode != 0:
            raise AssertionError(f"tune CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
        ServeSpec.from_json(dest.read_text()).validate()
        print(f"tune CLI: {time.perf_counter() - t0:.2f} s, {tail}", flush=True)


def serve_dense_gather(records: dict, bundle, prompts) -> dict:
    """The bf16 qwen2 fleet with ``paged_attention=False``: the verify step
    gathers the scheduled pool rows into a dense sub-cache and scatters
    them back, so the dense kernel runs every attention call and the paged
    one none."""
    served = serve("dense gather", records, bundle, prompts,
                   spec=serve_spec("engine", paged_attention=False),
                   path={"verify_attention_packed": None})
    paged = _launches()["verify_attention_paged"]
    if paged:
        raise AssertionError(f"dense gather: the paged kernel launched {paged} times")
    return served


def _procs_mentioning(text: str) -> list:
    """Pids of live processes whose command line contains ``text``."""
    import os

    pids = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                if text.encode() in (d / "cmdline").read_bytes():
                    pids.append(int(d.name))
            except OSError:
                pass
    return [p for p in pids if p != os.getpid()]


def cli_on_card() -> None:
    """``python -m repro_torch.cli`` in subprocesses on the card, each with a
    timeout and a TMPDIR of its own: serve with --check from a spec and from
    flags (a hybrid target and its default dense draft; a hybrid pair from
    a spec written here) and trace with the Prometheus exposition, the four
    at once; then top --demo over two spawned workers, after which no
    worker process and no socket directory may be left."""
    import os
    import tempfile

    root = Path(__file__).resolve().parent
    engine_json = root / "examples" / "specs" / "engine.json"
    remote_json = root / "examples" / "specs" / "cluster_remote.json"

    def run(args, tmp: str, timeout: float = 300.0) -> str:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "repro_torch.cli", *args], cwd=root,
                             env={**os.environ, "PYTHONPATH": str(root / "src"), "TMPDIR": tmp},
                             capture_output=True, text=True, timeout=timeout)
        if out.returncode != 0:
            raise AssertionError(f"cli {' '.join(args)} exited {out.returncode}:\n"
                                 f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
        tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
        print(f"cli {' '.join(args)}: {time.perf_counter() - t0:.2f} s, {tail[:160]}", flush=True)
        return out.stdout

    with tempfile.TemporaryDirectory() as tmp:
        hybrid_json = Path(tmp) / "hybrid.json"
        spec = json.loads(engine_json.read_text())
        spec["model"].update(arch="zamba2-1.2b", draft_arch="zamba2-1.2b")
        hybrid_json.write_text(json.dumps(spec))
        trace = Path(tmp) / "trace.jsonl"
        serves = (["--log-level", "info", "serve", "--spec", str(engine_json), "--check"],
                  ["serve", "--arch", "zamba2-1.2b", "--devices", "3", "--max-new", "8",
                   "--check"],
                  ["serve", "--spec", str(hybrid_json), "--check"])
        # the serves and the trace at once, each its own process on the card
        with ThreadPoolExecutor(len(serves) + 1) as pool:
            outs = list(pool.map(lambda args: run(args, tmp), [*serves, [
                "trace", "--spec", str(engine_json), "--out", str(trace), "--exposition"]]))
        for args, out in zip(serves, outs):
            if "greedy lock-step reference match: OK" not in out:
                raise AssertionError(f"cli {' '.join(args)}: no reference match line")
        out = outs[-1]
        rows = [json.loads(ln) for ln in trace.read_text().splitlines()]
        per_dev: dict = {}
        for r in rows:
            per_dev.setdefault(r["device_id"], []).append(r["round"])
        if not rows or any(sorted(v) != list(range(len(v))) for v in per_dev.values()):
            raise AssertionError(f"trace: rows are not one per session round: {per_dev}")
        if "repro_engine_verify_seconds_count" not in out:
            raise AssertionError("trace: the exposition lacks repro_engine_verify_seconds_count")
        print(f"cli trace: {len(rows)} rows, rounds per device "
              f"{ {d: len(v) for d, v in sorted(per_dev.items())} }", flush=True)

        out = run(["top", "--spec", str(remote_json), "--demo", "--iterations", "3",
                   "--interval", "0.5", "--no-clear"], tmp)
        frame = out.split("repro top — fleet control-plane poll")[-1].splitlines()
        rows = [ln.split() for ln in frame if ln[:1].isdigit()]
        if len(rows) != 2 or any(r[2] != "up" or int(r[4]) <= 0 for r in rows):
            raise AssertionError(f"top: the last frame lacks two live replicas with rounds:\n"
                                 + "\n".join(frame))
        left = _procs_mentioning(tmp) + [str(d) for d in Path(tmp).glob("repro-worker-*")]
        if left:
            raise AssertionError(f"top --demo left workers or socket directories: {left}")
        print(f"cli top: last frame rounds {[int(r[4]) for r in rows]}, nothing left after",
              flush=True)


def init_bundle(arch: str, target_layers: int = 0):
    """``full_width_bundle(arch)`` (at a depth cut when ``target_layers``),
    printing what it holds on the card: the target's parameters and bytes
    by its tensors (granite-34b's ``param_count()`` counts its gelu MLP as
    gated), and the device memory allocated after init."""
    bundle = full_width_bundle(arch, target_layers=target_layers)
    torch.cuda.synchronize()
    cfg = bundle.target_cfg
    params = list(bundle.target_params.parameters())
    cut = f", cut to {cfg.num_layers} of its layers" if target_layers else ""
    print(f"init {arch}: {cfg.num_layers} layers{cut}, {sum(p.numel() for p in params)} "
          f"parameters, {sum(p.numel() * p.element_size() for p in params)} bytes "
          f"({cfg.param_count()} parameters by the config at this depth), device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    return bundle


def prefix_vlm(bundle, prompts) -> None:
    """The vlm prefill behind the stub frontend on the card: 2 prompts of
    199 tokens behind ``num_patches`` (576) stub patch embeddings
    (model_zoo.frontend_stub), so the dense kernel attends 775 rows over a
    cache of 800 positions: finite logits, the cache's length 775, one
    kernel launch a layer. Then the same prefix with the first 194 tokens
    (770 rows), a decode_forward of the last 5 tokens (positions 770..774)
    and their commit, held to the whole prefill:
      - the length 775, and every layer's K and V at positions 0..769 the
        whole prefill's bit for bit (the prefix's positions in the cache);
      - layer 0's K and V at 770..774 within KERNEL_TOL of the whole's
        (the decode's positions): their products run at 10 rows against
        1,550, which moves them by a bf16 ulp, where a decode placed one
        position late moves layer 0's K by far more (run here as a control,
        which must exceed KERNEL_TOL);
      - the last logits within LOGIT_TOL of the whole prefill's for the
        bundle's draft (the target's embedding, layer 0, norm and head).
        Through the target's 32 layers that ulp grows to a few tenths
        (0.288 against 4.89 for the control on this card; PERF.md), so the
        target's difference is printed beside the control's, not bounded."""
    from repro_torch.models.model_zoo import frontend_stub

    cfg = bundle.target_cfg
    stub = frontend_stub(cfg, 2, torch.Generator(device="cuda").manual_seed(5))
    toks = torch.from_numpy(np.ascontiguousarray(prompts[:2, :199])).to("cuda")
    n = cfg.num_patches + toks.shape[1]

    def prefill(model, params, tokens):
        cache = model.make_cache(2, 800, device="cuda", attn_chunk=32)
        return model.prefill(params, tokens, cache, attn_chunk=32, embeds_prefix=stub)

    def split(model, params, late: int = 0):
        """The last logits and the cache of the split path; ``late`` shifts
        its decode that many positions on."""
        _, part = prefill(model, params, toks[:, :-5])
        part = {**part, "length": part["length"] + late}
        h, part = model.decode_forward(params, part, toks[:, -5:], attn_chunk=32)
        part = model.commit(part, torch.full((2,), 5, device="cuda"))
        return model.lm_head(params, h[:, -1:])[:, 0], part

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item()

    _reset_launches()
    t0 = time.perf_counter()
    whole, full = prefill(bundle.target, bundle.target_params, toks)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = _launches()["verify_attention_packed"]
    finite = bool(torch.isfinite(whole).all())
    if not finite or full["length"].tolist() != [n, n] or launched != cfg.num_layers:
        raise AssertionError(f"prefix vlm: logits finite {finite}, length "
                             f"{full['length'].tolist()} (want {n}), {launched} dense kernel "
                             f"launches for {cfg.num_layers} layers")
    print(f"prefix vlm: 2 x ({cfg.num_patches} patches + 199 tokens) in {seconds:.3f} s, length "
          f"{n}, {launched} dense kernel launches", flush=True)
    last, part = split(bundle.target, bundle.target_params)
    late_last, late = split(bundle.target, bundle.target_params, late=1)
    prefix_same = all(torch.equal(part[k][:, :, :n - 5], full[k][:, :, :n - 5]) for k in "kv")
    fresh = max(diff(part[k][0, :, n - 5:n], full[k][0, :, n - 5:n]) for k in "kv")
    control = diff(late["k"][0, :, n - 4:n + 1], full["k"][0, :, n - 5:n])
    target_err, control_err = diff(last, whole), diff(late_last, whole)
    draft_err = diff(split(bundle.draft, bundle.draft_params)[0],
                     prefill(bundle.draft, bundle.draft_params, toks)[0])
    print(f"prefix vlm: {n - 5} rows + decode of 5 + commit: length {part['length'].tolist()}; "
          f"K/V at 0..{n - 6} equal to the whole prefill's in every layer: {prefix_same}; "
          f"layer-0 K/V at {n - 5}..{n - 1} max abs diff {fresh:.4g} (a decode one position "
          f"late: K {control:.4g}); last logits max abs diff: draft {draft_err:.4g} (LOGIT_TOL "
          f"{LOGIT_TOL}), target {target_err:.4g} (one position late: {control_err:.4g})",
          flush=True)
    if part["length"].tolist() != [n, n] or not prefix_same:
        raise AssertionError("prefix vlm: the split prefill's cache differs from the whole's")
    if not fresh <= KERNEL_TOL < control:
        raise AssertionError(f"prefix vlm: the decoded rows' layer-0 K/V differ by {fresh} "
                             f"(a late decode by {control}; bound {KERNEL_TOL})")
    if not draft_err < LOGIT_TOL:
        raise AssertionError(f"prefix vlm: the draft's split logits differ by {draft_err}")


def serve_dense_config(label: str, records: dict, bundle, prompts, *, max_new: int) -> None:
    """One of the dense configs (or the vlm backbone) at full width: the
    fleet of 6 on the engine backend through both bf16 kernels, then held
    to the reference backend with the replay witness (a 32- to 88-layer
    target carries a last-bit difference of a product further than
    qwen2-1.5b; see check()). Acceptance printed, not required."""
    cfg = bundle.target_cfg
    kw = dict(max_new=max_new, target_layers=cfg.num_layers)
    served = _phase(f"serve {label}", lambda: serve(
        label, records, bundle, prompts, spec=serve_spec("engine", cfg.name, **kw),
        path=BF16_PATH, need_accepted=False))
    _phase(f"check {label}", lambda: check(label, bundle, prompts, served,
                                           spec=serve_spec("reference", cfg.name, **kw),
                                           witness=True))


# whisper's text context: the decoder's learned position table (arXiv:2212.04356)
WHISPER_MAX_POS = 448
# every attention entry the encdec phase's prefills and one-a-step decode
# launch: per prefill 4 decoder layers (dense, causal) and 4 encoder + 4
# cross calls (dense, non-causal); per step 4 self (paged) + 4 cross (paged,
# non-causal)
ENCDEC_PATH = {
    "verify_attention_packed": ENCDEC_STREAMS * ENCDEC_L,
    "verify_attention_packed_noncausal": ENCDEC_STREAMS * 2 * ENCDEC_L,
    "verify_attention_paged": ENCDEC_NEW * ENCDEC_L,
    "verify_attention_paged_noncausal": ENCDEC_NEW * ENCDEC_L,
}


def init_whisper():
    """Full-width whisper-tiny on the card from a seed: (model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("whisper-tiny")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               max_pos=WHISPER_MAX_POS)
    torch.cuda.synchronize()
    tensors = list(params.parameters())
    print(f"init whisper-tiny: {cfg.num_layers} decoder + {cfg.encoder_layers} encoder layers of "
          f"{cfg.d_model}, {sum(p.numel() for p in tensors)} parameters "
          f"({cfg.param_count()} by the config), "
          f"{sum(p.numel() * p.element_size() for p in tensors)} bytes, device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    return model, params


def serve_encdec(records: dict, model, params) -> None:
    """whisper-tiny's serving path on the card: 6 streams of prompt 64
    behind 1500 stub frames each, prefilled one by one through
    make_prefill_step(with_frontend=True) into a PagedKVCache of 7 rows,
    then 32 greedy tokens one a step through the slot-indexed forward (the
    paged verify step's forward at Sq = 1: speculative_verify takes K >= 1
    drafts), then teacher-forced in windows of K+1 = 5 through
    make_paged_verify_step, every argmax the one-a-step token up to near
    ties (top-2 gap < LOGIT_TOL, printed)."""
    from repro_torch.core import verification
    from repro_torch.models.kvcache import PagedKVCache
    from repro_torch.models.model_zoo import frontend_stub

    cfg, dev = model.cfg, torch.device("cuda")
    n, P, chunk = ENCDEC_STREAMS, ENCDEC_PROMPT, 32
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(n, P)).astype(np.int32)).to(dev)
    frames = frontend_stub(cfg, n, torch.Generator(device=dev).manual_seed(5))
    pool = PagedKVCache(model, n_slots=n, max_len=128, device=dev, attn_chunk=chunk,
                        enc_len=cfg.encoder_seq)
    prefill = verification.make_prefill_step(model, attn_chunk=chunk, with_frontend=True)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    slot_ids, last = [], []
    for i in range(n):
        _, row, tok = prefill(params, pool.make_row_cache(), toks[i:i + 1], frames[i:i + 1])
        slot = pool.alloc()
        pool.write_slot(slot, row)
        slot_ids.append(slot)
        last.append(tok)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    slots = torch.tensor(slot_ids, dtype=torch.int32, device=dev)
    idx = slots.long()
    prev = torch.cat(last).to(torch.int32)
    greedy = []
    t0 = time.perf_counter()
    for _ in range(ENCDEC_NEW):
        h, cache = model.decode_forward(params, pool.cache, prev[:, None], attn_chunk=chunk,
                                        slots=slots)
        logits = model.lm_head(params, h)[:, -1]
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("encdec: a step's logits are not all finite")
        prev = logits.argmax(-1).to(torch.int32)
        length = cache["length"].clone()
        length[idx] += 1
        pool.cache = {**cache, "length": length}
        greedy.append(prev)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    _record_launches("encdec", records, ENCDEC_PATH, _launches())
    stream = torch.stack(greedy, dim=1)  # (n, 32)
    print(f"encdec: {n} prefills of {P - 1} tokens behind {cfg.encoder_seq} frames in "
          f"{prefill_s:.3f} s, {ENCDEC_NEW} steps in {decode_s:.3f} s "
          f"({decode_s / ENCDEC_NEW * 1e3:.2f} ms a step, {n * ENCDEC_NEW / decode_s:.1f} "
          f"tokens/s), bytes_per_slot {pool.bytes_per_slot()}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; distinct tokens per stream "
          f"{[len(set(r)) for r in stream.tolist()]}", flush=True)

    # after the steps, each slot's cross leaves are those of a fresh prefill
    # of its stream, bit for bit (write_slot put each row in its slot and no
    # step wrote them); a batched prefill of the 6 streams gives them within
    # KERNEL_TIGHT
    leaves = ("cross_k", "cross_v")
    for i, slot in enumerate(slot_ids):
        fresh = prefill(params, pool.make_row_cache(), toks[i:i + 1], frames[i:i + 1])[1]
        for leaf in leaves:
            if not torch.equal(pool.cache[leaf][:, slot], fresh[leaf][:, 0]):
                raise AssertionError(f"encdec: pool row {slot}'s {leaf} differs from a fresh "
                                     "prefill of its stream")
    dense = model.make_cache(n, 128, device=dev, attn_chunk=chunk, enc_len=cfg.encoder_seq)
    _, dense = model.prefill(params, toks[:, :-1], dense, attn_chunk=chunk, enc_frames=frames)
    pooled = {leaf: pool.cache[leaf][:, idx] for leaf in leaves}
    batched = max((dense[leaf].float() - pooled[leaf].float()).abs().max().item()
                  for leaf in leaves)
    same = all(torch.equal(dense[leaf], pooled[leaf]) for leaf in leaves)
    print(f"encdec: each slot's cross leaves == a fresh prefill's bit for bit; a batched "
          f"prefill's cross leaves max abs diff {batched:.4g} (bit-equal: {same})", flush=True)
    if not batched <= KERNEL_TIGHT:
        raise AssertionError(f"encdec: a batched prefill's cross leaves differ by {batched} "
                             f"> {KERNEL_TIGHT}")
    del dense, pooled

    # teacher-forced windows through the paged verify step
    length = pool.cache["length"].clone()
    length[idx] = P - 1
    pool.cache = {**pool.cache, "length": length}
    seen = []
    forced = dataclasses.replace(model, lm_head=lambda p, h: seen.append(model.lm_head(p, h))
                                 or seen[-1])
    step = verification.make_paged_verify_step(forced, scratch_slot=pool.scratch_slot,
                                               attn_chunk=chunk)
    prev = torch.cat(last).to(torch.int32)
    W = ENCDEC_K + 1
    windows = -(-ENCDEC_NEW // W)
    padded = torch.cat([stream, torch.zeros((n, windows * W - ENCDEC_NEW), dtype=torch.int32,
                                            device=dev)], dim=1)
    ties, checked = [], 0
    _reset_launches()
    t0 = time.perf_counter()
    for w in range(windows):
        drafts = padded[:, w * W:w * W + ENCDEC_K]
        batch = verification.make_verify_batch(prev, drafts,
                                               torch.full((n,), ENCDEC_K, device=dev))
        _, cache = step(params, pool.cache, slots, batch)
        am = seen[-1].argmax(-1)  # (n, K+1)
        for j in range(min(W, ENCDEC_NEW - w * W)):
            pos = w * W + j
            checked += n
            for b in torch.nonzero(am[:, j] != stream[:, pos]).flatten().tolist():
                top = torch.topk(seen[-1][b, j], 2).values
                gap = float(top[0] - top[1])
                ties.append((b, pos, gap))
                print(f"encdec: stream {b} token {pos}: window argmax {int(am[b, j])}, one a "
                      f"step {int(stream[b, pos])}; top-2 gap {gap:.4g}", flush=True)
        length = cache["length"].clone()
        length[idx] = P - 1 + (w + 1) * W  # teacher-forced: the whole window commits
        pool.cache = {**cache, "length": length}
        prev = padded[:, w * W + ENCDEC_K]
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    path = {"verify_attention_paged": windows * ENCDEC_L,
            "verify_attention_paged_noncausal": windows * ENCDEC_L}
    _record_launches("encdec windows", records, path, _launches())
    print(f"encdec: {windows} teacher-forced windows of {W} in {window_s:.3f} s: "
          f"{checked - len(ties)}/{checked} argmaxes equal the one-a-step tokens, "
          f"{len(ties)} near ties", flush=True)
    bad = [t for t in ties if not t[2] < LOGIT_TOL]
    if bad:
        raise AssertionError(f"encdec: windows leave the one-a-step tokens at {bad} "
                             f"(top-2 gaps >= {LOGIT_TOL})")


def checkpoint_phase(params) -> None:
    """The full-width whisper-tiny params (the bridge's JAX-layout tree of
    torch tensors) saved from the card with repro_torch.checkpoint and
    restored onto it: every tensor bit-equal, its dtype and shape kept."""
    import shutil
    import tempfile

    from repro_torch import bridge, checkpoint

    tree = bridge.params_tree(params)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(d, 0, tree)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        back, _ = checkpoint.restore(d, tree, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d)

    def leaves(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{path}/{k}")
        else:
            yield path, t

    want, got = dict(leaves(tree)), dict(leaves(back))
    if sorted(want) != sorted(got):
        raise AssertionError("checkpoint: the restored tree has other keys")
    for key, w in want.items():
        g = got[key]
        if not (g.is_cuda and g.dtype == w.dtype and torch.equal(g, w)):
            raise AssertionError(f"checkpoint: {key} restored as {g.dtype} on {g.device}, "
                                 "not bit-equal")
    print(f"checkpoint: whisper-tiny, {len(want)} tensors, {nbytes} bytes on disk, save "
          f"{save_s:.3f} s, restore onto the card {restore_s:.3f} s, every tensor bit-equal; "
          f"temp dir removed: {not Path(d).exists()}", flush=True)


# the train phases: the launcher's defaults (B 8, S 128, loss and
# attention chunks 64, remat, lr 1e-3 with warmup 10), 8 steps
TRAIN_STEPS, TRAIN_B, TRAIN_S = 8, 8, 128
# step 1's gradients with the kernels against the same step with the plain
# version on the card: each leaf within this relative Frobenius distance
# (the attention kernels' backward and autograd of the plain forward differ
# by the rounding of P and O, GRAD_TIGHT; the SSD kernels' by their sums'
# order and the bf16 rounding of y, dx, dB and dC). The controls, the
# kernels' forward with the plain backward off by one position (attention:
# a causal limit one position late; the SSD scan: dy one step late), must
# lie beyond it.
GRAD_LEAF_TOL = 5e-2


def _train_on_card(label: str, arch: str, records: dict, *, op: str, what: str, swaps: dict,
                   control: str, path, steps: int = TRAIN_STEPS,
                   falling: str = "last step") -> None:
    """``arch`` at full width trained ``steps`` steps through
    repro_torch.training on a card freed of the serve bundles: step 1's
    gradients with the kernels against the same step with ``swaps["plain"]``
    in place of ``ops.<op>`` (a harness swap; the port never runs the plain
    version on the card) within GRAD_LEAF_TOL, ``swaps["control"]`` beyond
    it (and, where ``swaps`` has ``"plain backward"``, the kernels' forward
    with the plain backward, the kernels' distance from it and its own from
    the plain version printed); then the steps: seconds each, tokens/s, peak
    memory, losses finite and falling, and each kernel launched as
    ``path(cfg, steps)`` says. ``falling``: "last step", the last step's
    loss below the first's; "batch 0", step 1's batch, evaluated again
    after the steps, below its loss at step 1 (each step sees a fresh
    batch, whose loss the warmup's steps need not lower)."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model_zoo import build_model
    from repro_torch.training import data, optimizer as O, train_step as TS

    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"{label}: init {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in params.parameters())} parameters", flush=True)
    tcfg = TS.TrainConfig(
        optimizer=O.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps),
        remat=True, loss_chunk=64, attn_chunk=64)
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S + 1,
                           global_batch=TRAIN_B)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in data.batch_at(dcfg, s).items()}
               for s in range(steps)]
    loss_fn = TS.make_loss_fn(model, tcfg)

    def step1_grads(swap=None):
        kernel = getattr(ops, op)
        if swap is not None:
            setattr(ops, op, swaps[swap])
        try:
            for p in params.parameters():
                p.requires_grad_(True)
                p.grad = None
            loss, _ = loss_fn(params, batches[0])
            loss.backward()
            grads = bridge.grads_tree(params)
            for p in params.parameters():
                p.grad = None
            return loss.item(), grads
        finally:
            setattr(ops, op, kernel)

    (loss_k, g_k), (loss_p, g_p) = step1_grads(), step1_grads("plain")
    loss_c, g_c = step1_grads("control")
    worst, ctrl = _worst_leaf(g_k, g_p), _worst_leaf(g_c, g_p)
    del g_c
    if "plain backward" in swaps:
        g_b = step1_grads("plain backward")[1]
        own, fwd = _worst_leaf(g_k, g_b), _worst_leaf(g_b, g_p)
        print(f"{label}: the kernels' forward with the plain backward: the kernels' worst leaf "
              f"{own[1]} {own[0]:.4g} from it (the backward kernels' share), its own {fwd[1]} "
              f"{fwd[0]:.4g} from the plain {what}'s (the forward's share)", flush=True)
        del g_b
    del g_k, g_p
    torch.cuda.empty_cache()  # the plain version's odd-sized blocks, before the big state
    print(f"{label}: step 1 loss {loss_k!r} with the kernels, {loss_p!r} with the plain "
          f"{what}; the gradients' worst leaf {worst[1]} {worst[0]:.4g} relative "
          f"(bound {GRAD_LEAF_TOL})", flush=True)
    print(f"{label}: control ({control}): loss {loss_c!r}, worst leaf {ctrl[1]} {ctrl[0]:.4g} "
          f"relative, fails the bound: {ctrl[0] > GRAD_LEAF_TOL}", flush=True)
    if not worst[0] <= GRAD_LEAF_TOL:
        raise AssertionError(f"{label}: leaf {worst[1]}'s gradient is {worst[0]} off the "
                             f"plain {what}'s (> {GRAD_LEAF_TOL})")
    if not ctrl[0] > GRAD_LEAF_TOL:
        raise AssertionError(f"{label}: the off-by-one control is within GRAD_LEAF_TOL "
                             f"({ctrl[0]} <= {GRAD_LEAF_TOL}): the bound cannot catch it")

    step = TS.make_train_step(model, tcfg)
    opt = O.adamw_init(bridge.params_tree(params))
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, err = [], [], None
    for s in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, err, m = step(params, opt, err, batches[s])
        losses.append(float(m["loss"]))
        seconds.append(time.perf_counter() - t0)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_B * TRAIN_S
    steady = seconds[1:]
    print(f"{label}: {steps} steps of {TRAIN_B} x {TRAIN_S} tokens, seconds "
          f"{[round(x, 4) for x in seconds]}, {tokens * len(steady) / sum(steady):.1f} tokens/s "
          f"after the first step, peak device memory {peak:.2f} GiB, losses {losses}, last "
          f"grad norm {float(m['grad_norm']):.4g}, lr {float(m['lr']):.4g}", flush=True)
    if falling == "batch 0":
        with torch.no_grad():
            again = float(loss_fn(params, batches[0])[0])
        print(f"{label}: step 1's batch after the {steps} steps: loss {again!r} (at step 1: "
              f"{losses[0]!r})", flush=True)
        fell = again < losses[0]
    else:
        fell = losses[-1] < losses[0]
    if not all(math.isfinite(x) for x in losses) or not fell:
        raise AssertionError(f"{label}: losses {losses} not finite and falling ({falling})")
    _record_launches(label, records, path(cfg, steps), launches)


def train_qwen2(records: dict) -> None:
    """Full-width qwen2-1.5b (28 layers of 1536, vocab 151936): the plain
    attention against the backward kernels at step 1; each backward kernel
    launched layers x steps times, the forward kernel twice as often
    (remat)."""
    from repro_torch.kernels import ref, verify_attn

    class LateBackward(torch.autograd.Function):
        """The control: the forward kernel, and the plain backward with the
        causal limit one position late (kv_valid + 1)."""

        @staticmethod
        def forward(ctx, q, k, v, kv, causal):
            out = verify_attn.verify_attention_packed(q, k, v, kv, causal=causal)
            ctx.save_for_backward(q, k, v, out, kv)
            ctx.causal = causal
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, kv = ctx.saved_tensors
            return (*ref.attention_bwd_ref(q, k, v, out, dout, kv + 1, causal=ctx.causal),
                    None, None)

    swaps = {
        "plain": lambda q, k, v, kv, *, causal=True, block_k=64: (
            ref.verify_attention_ref(q, k, v, kv, block_k=block_k, causal=causal)),
        "control": lambda q, k, v, kv, *, causal=True, block_k=64: (
            LateBackward.apply(q.contiguous(), k.contiguous(), v.contiguous(), kv, causal)),
    }

    def path(cfg, steps):
        n = cfg.num_layers * steps
        return {"attn_bwd_delta": n, "attn_bwd_dkdv": n, "attn_bwd_dq": n,
                "verify_attention_packed": 2 * n}

    _train_on_card("train qwen2", "qwen2-1.5b", records, op="attention", what="attention",
                   swaps=swaps, control="the kernels' forward, the plain backward one position "
                   "late", path=path)


def _ssd_swaps() -> dict:
    """ops.ssd_scan's harness swaps for the SSD train phases: the plain scan
    (autograd differentiates it); the scan kernel's forward with the plain
    backward (which splits the kernels' distance from the plain scan into
    the backward kernels' share and the forward's); and the control, the
    same on dy one step late (dy_{t+1} at step t)."""
    from repro_torch.kernels import ref, ssd_scan

    class PlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, Bm, Cm, h0, chunk, late):
            y, h = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)
            ctx.save_for_backward(x, dt, A, Bm, Cm)
            ctx.h0, ctx.chunk, ctx.late = h0, chunk, late
            return y, h

        @staticmethod
        def backward(ctx, dy, dh):
            x, dt, A, Bm, Cm = ctx.saved_tensors
            if ctx.late:
                dy = torch.cat([dy[:, 1:], torch.zeros_like(dy[:, :1])], dim=1)
            grads = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, ctx.h0, dy, dh, chunk=ctx.chunk)
            return (*grads[:5], grads[5] if ctx.needs_input_grad[5] else None, None, None)

    return {
        "plain": lambda x, dt, A, Bm, Cm, h0=None, *, chunk: (
            ref.ssd_scan_ref(x, dt, A, Bm, Cm, h0, chunk=chunk)),
        "plain backward": lambda x, dt, A, Bm, Cm, h0=None, *, chunk: (
            PlainBackward.apply(x, dt, A, Bm, Cm, h0, chunk, False)),
        "control": lambda x, dt, A, Bm, Cm, h0=None, *, chunk: (
            PlainBackward.apply(x, dt, A, Bm, Cm, h0, chunk, True)),
    }


def train_ssm(records: dict, label: str, arch: str, steps: int = TRAIN_STEPS) -> None:
    """Full-width mamba2-370m or zamba2-1.2b: the plain SSD scan against the
    scan's kernels at step 1; the scan kernel launched twice a layer and
    step (remat), its backward once; for zamba2 also the attention kernels
    of the shared block's 6 applications a step, the forward twice each.
    The losses fall on step 1's batch evaluated again after the steps:
    zamba2's fresh batches at the launcher's warmup need not (10.777 at the
    first step, 10.842 at the eighth; that batch again 10.643), as the JAX
    package's own reduced hybrid's do not fall over its first 5 steps
    (tests/test_torch_training.py)."""
    from repro_torch.models.hybrid import n_apps

    def path(cfg, steps):
        n = cfg.num_layers * steps
        want = {"ssd_scan": 2 * n, "ssd_scan_bwd": n}
        if cfg.family == "hybrid":
            a = n_apps(cfg) * steps
            want.update({"attn_bwd_delta": a, "attn_bwd_dkdv": a, "attn_bwd_dq": a,
                         "verify_attention_packed": 2 * a})
        return want

    _train_on_card(label, arch, records, op="ssd_scan", what="SSD scan", swaps=_ssd_swaps(),
                   control="the scan kernel's forward, the plain backward on dy one step late",
                   path=path, steps=steps, falling="batch 0")


def _worst_leaf(got, want):
    """(relative Frobenius distance, leaf) of the leaf of ``got`` furthest
    from ``want``'s."""
    return max(((((g.float() - _tree_get(want, key).float()).norm()
                   / _tree_get(want, key).float().norm().clamp(min=1e-30)).item(), key)
                for key, g in _tree_items(got)), key=lambda pair: pair[0])


def _tree_items(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, path + (k,))
    else:
        yield "/".join(path), tree


def _tree_get(tree, key: str):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def train_whisper(records: dict) -> None:
    """python -m repro_torch.launch.train --arch whisper-tiny at full width
    (1500 stub frames; the decoder at the launcher's B 8, S 128), 6 steps
    straight and, in a second process at the same time, 6 steps with
    --fail-at 3 --ckpt-every 2 (exits non-zero after steps 0-2, with the
    checkpoint of the three); then a rerun that resumes at step 3: the
    resumed run's step-6 checkpoint (params and optimizer state) and its
    last loss equal the straight run's bit for bit. Each run's launches, which the launcher prints, are those of the
    steps it ran: a step runs each backward kernel once for each of the 4
    encoder layers' self-attentions and the 4 decoder layers' self- and
    cross-attentions, the causal forward twice a decoder layer (remat) and
    the non-causal one once an encoder layer and twice a cross-attention.
    Recorded under the path "train whisper" (their sum), which is no
    kernel's main path."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    cfg = get_config("whisper-tiny")
    enc, dec = cfg.encoder_layers, cfg.num_layers
    per_step = {"attn_bwd_delta": enc + 2 * dec, "attn_bwd_dkdv": enc + 2 * dec,
                "attn_bwd_dq": enc + 2 * dec, "verify_attention_packed": 2 * dec,
                "verify_attention_packed_noncausal": enc + 2 * dec}

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "whisper-tiny",
            "--steps", "6"]

    def run(*args):
        t0 = time.perf_counter()
        proc = subprocess.run([*base, *args], capture_output=True, text=True, env=env,
                              cwd=root, timeout=600)
        secs = time.perf_counter() - t0
        print(f"train whisper: {' '.join(args)}: exit {proc.returncode} in {secs:.2f} s; "
              f"{' | '.join(proc.stdout.strip().splitlines())}", flush=True)
        return proc

    try:
        with ThreadPoolExecutor(2) as pool:  # the two first runs share the card at once
            straight = pool.submit(run, "--ckpt-dir", str(d / "straight"))
            broken = pool.submit(run, "--ckpt-dir", str(d / "broken"), "--ckpt-every", "2",
                                 "--fail-at", "3")
            straight, broken = straight.result(), broken.result()
        resumed = run("--ckpt-dir", str(d / "broken"), "--ckpt-every", "2")
        if straight.returncode != 0 or resumed.returncode != 0:
            raise AssertionError(f"train whisper: a run failed:\n{straight.stderr[-3000:]}\n"
                                 f"{resumed.stderr[-3000:]}")
        if broken.returncode == 0 or "[resume] restored step 3" not in resumed.stdout:
            raise AssertionError("train whisper: --fail-at 3 did not fail, or the rerun did not "
                                 "resume at step 3")
        total = dict.fromkeys(per_step, 0)
        for label, proc, marker, steps in (("straight", straight, "done.", 6),
                                           ("crash", broken, "crashed.", 3),
                                           ("resume", resumed, "done.", 3)):
            line = next((ln for ln in proc.stdout.splitlines() if ln.startswith(marker)), "")
            got = json.loads(line.split(" launches ", 1)[1]) if " launches " in line else {}
            want = {name: n * steps for name, n in per_step.items()}
            print(f"train whisper: {label} run, {steps} steps: launches {got}", flush=True)
            if got != want:
                raise AssertionError(f"train whisper: the {label} run launched {got}, "
                                     f"expected {want}")
            total = {name: total[name] + got[name] for name in total}
        _record_launches("train whisper", records, total, total, main_path=False)
        a = np.load(d / "straight" / "step_000000006" / "arrays.npz")
        b = np.load(d / "broken" / "step_000000006" / "arrays.npz")
        differ = sorted(set(a.files) ^ set(b.files)) + [
            k for k in sorted(set(a.files) & set(b.files)) if not np.array_equal(a[k], b[k])]
        same = not differ
        last = [ln.split(" launches ", 1)[0] for p in (straight, resumed)
                for ln in p.stdout.splitlines() if ln.startswith("done.")]
        print(f"train whisper: {len(a.files)} arrays of the step-6 checkpoints bit-equal: "
              f"{same} (differing: {differ}); last lines {last}", flush=True)
        if not same or len(last) != 2 or last[0] != last[1]:
            raise AssertionError("train whisper: the resumed run differs from the straight one")
    finally:
        shutil.rmtree(d, ignore_errors=True)


# mesh phase: four ranks on the card over gloo (launch.mesh.make_debug_mesh(2, 2))
MESH_SHAPE = (2, 2)
MESH_TIMEOUT_S = 420.0
MESH_K = 4
# a run of the mesh phase: its config (layers 0: all), batch, cache length,
# prompt, verify rounds, seed, the kernels each rank must launch on the
# mesh path (ssd_scan: once per layer, in the prefill; the verify rounds
# run the recurrence), and the largest max abs difference of the f32
# logits (the prefill's and every round's) that a rank may show from one
# rank's: about twice the tensor-parallel sum order's difference measured
# on an H100 at these seeds (zamba2's grows through its 38 SSD layers to
# ~0.75, as one unit in the last place on the shared blocks' outputs
# does), under what a rank that puts the SSD heads in each other's place
# gives (4.0 on mamba2, 5.2 on zamba2; experiments/
# torch_mesh_sensitivity.py); mamba2's, whose ranks differ from one
# rank's only in the head's product over half the vocabulary, 1e-5
MeshRun = collections.namedtuple(
    "MeshRun", "arch layers batch max_len prompt rounds seed kernels logit_bound")
# granite-34b at full width cut to 16 of its 88 layers: four ranks share the
# card, ~3.3e9 parameters a rank at tp 2 (its 88 layers would need ~135 GB);
# its 4096-position cache is sequence-sharded (one KV head), 2048 a model
# rank, and the 2046-token prompt puts the first verify's 5 rows at
# 2045..2049, across the boundary. granite-moe-3b-a800m at full width and
# depth, its dropless twin: KV heads (8) and experts (40: 20 a rank) split.
# mamba2-370m (32 SSD heads, 16 a rank), zamba2-1.2b (64 SSD heads, 32 a
# rank; the shared block's 32 KV heads, 16 a rank), whisper-tiny (behind
# 1500 stub frames: the encoder and the cross K/V on 3 of the 6 heads) and
# llava-next-mistral-7b (576 stub patches before 199 prompt tokens, the
# token lookup vocabulary-parallel) at full width and depth.
MESH_RUNS = {
    "granite-34b": MeshRun("granite-34b", 16, 4, 4096, 2046, 8, 11,
                           ("verify_attention_packed_shard",), 0.25),
    "granite-moe": MeshRun("granite-moe-3b-a800m", 0, 4, 256, 200, 8, 12,
                           ("verify_attention_packed",), 0.15),
    "mamba2": MeshRun("mamba2-370m", 0, 4, 256, 200, 8, 13, ("ssd_scan",), 1e-5),
    "zamba2": MeshRun("zamba2-1.2b", 0, 4, 256, 200, 8, 14,
                      ("ssd_scan", "verify_attention_packed"), 2.0),
    "whisper": MeshRun("whisper-tiny", 0, 4, 128, 64, 8, 15,
                       ("verify_attention_packed", "verify_attention_packed_noncausal"), 0.05),
    "llava": MeshRun("llava-next-mistral-7b", 0, 4, 1024, 200, 8, 16,
                     ("verify_attention_packed",), 0.6),
}


def _mesh_cfg(arch: str, layers: int):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.family == "moe":  # the dropless twin: no assignment is dropped at any batch
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg


def _mesh_leaf(cfg, leaf: str, shape, gen) -> torch.Tensor:
    """One weight of the init's distributions (f32, on the card): N(0,
    0.02), the output projections N(0, 0.02 / sqrt(2 L)), learned positions
    N(0, 0.01), the conv N(0, 0.2); norms and gnorm 1, biases 0, the SSD
    decay log(1..16), as the families' ``init_params``. The SSD layers' D
    is drawn from N(0, 0.1) and dt_bias is 0 (dt = softplus(dt) where the
    init's gives 0.01): at the init's D = 1 and dt 0.01 the skip term
    swamps the scan, and a rank that scans or gathers the wrong heads moves
    the logits by no more than the mesh's rounding."""
    if leaf in ("scale", "gnorm"):
        return torch.ones(shape, device="cuda")
    if leaf in ("bias", "bq", "bk", "bv", "conv_b", "dt_bias"):
        return torch.zeros(shape, device="cuda")
    if leaf == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[0], device="cuda"))
    std = {"wo": 0.02 / math.sqrt(2 * cfg.num_layers), "pos_embed": 0.01, "conv_w": 0.2,
           "D": 0.1}
    std["wd"] = std["out_proj"] = std["wo"]
    return torch.randn(shape, generator=gen, device="cuda") * std.get(leaf, 0.02)


def _mesh_weights(cfg, seed: int, policy=None):
    """The model's weights (a ``Transformer``, ``Mamba2`` or ``Hybrid``),
    each tensor drawn in full on the card from a generator of its own
    (``_mesh_leaf``) and, under a ``policy``, cut to this rank's piece at
    once: the same weights on one rank and on the mesh, and never a full
    model on a rank."""
    from repro_torch import bridge
    from repro_torch.sharding.policy import local_shard, port_param_specs

    kw = {} if cfg.use_rope else {"max_pos": WHISPER_MAX_POS}
    model = bridge._MODELS[cfg.family](cfg, device="meta", **kw)
    specs = port_param_specs(policy, model) if policy is not None else {}
    with torch.no_grad():
        for i, (name, p) in enumerate(list(model.named_parameters())):
            gen = torch.Generator(device="cuda").manual_seed(seed * 100_003 + i)
            full = _mesh_leaf(cfg, name.rsplit(".", 1)[-1], p.shape, gen).to(p.dtype)
            if any(specs.get(name, ())):
                full = local_shard(full, specs[name], policy.mesh)
            model.set_weight(name, full)
    return model


def _mesh_reference(label: str, work: Path) -> dict:
    """One rank: the run's prefill and verify rounds on the full model, the
    rows of each data rank apart (B / n_data rows a call: the batch shape
    each mesh rank runs, so that what differs from the ranks is the mesh's;
    on the card a matmul over 10 rows and over 20 can round differently).
    Round r's drafts are the greedy tokens for its first r % 3 positions
    and a wrong one after, so every row accepts r % 3 drafts and the rows
    keep one length (the sequence-sharded cache's padded-batch contract).
    Saves the prompts (and the stub frontend's frames or patches), the
    prefill's logits, each round's batch, results, logits (all B rows) and
    their top-2 gaps, and the batch shape's own noise: the prefill's
    logits of each row alone against its block's."""
    from repro_torch.core import verification
    from repro_torch.kernels import verify_attn
    from repro_torch.models.model_zoo import build_model, frontend_stub

    run = MESH_RUNS[label]
    B, max_len, seed = run.batch, run.max_len, run.seed
    cfg = _mesh_cfg(run.arch, run.layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = _mesh_weights(cfg, seed)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, run.prompt)).astype(np.int32))
    stub = frontend_stub(cfg, B, torch.Generator(device="cuda").manual_seed(seed))
    b = B // MESH_SHAPE[0]
    blocks = [slice(i * b, (i + 1) * b) for i in range(MESH_SHAPE[0])]
    prefill = verification.make_prefill_step(model, with_frontend=stub is not None)
    step = verification.make_verify_step(model)
    caches, prevs, first = [], [], []
    for rows in blocks:
        logits, cache, prev = prefill(params, model.make_cache(b, max_len, device="cuda"),
                                      prompts[rows].cuda(), None if stub is None else stub[rows])
        caches.append(cache)
        prevs.append(prev)
        first.append(logits.cpu())
    alone = [prefill(params, model.make_cache(1, max_len, device="cuda"),
                     prompts[i:i + 1].cuda(), None if stub is None else stub[i:i + 1])[0].cpu()
             for i in range(B)]
    rec = {"prompts": prompts, "stub": None if stub is None else stub.cpu(),
           "prefill": torch.cat(first), "rounds": []}
    rec["batch_noise"] = (torch.cat(alone) - rec["prefill"]).abs().max().item()
    lengths = torch.full((b,), MESH_K, dtype=torch.int32, device="cuda")
    for r in range(run.rounds):
        accept = r % 3
        all_drafts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, MESH_K)).astype(np.int32))
        parts = []
        for j, rows in enumerate(blocks):
            drafts = all_drafts[rows].cuda()
            for i in range(accept + 1):
                h, _ = model.decode_forward(params, caches[j],
                                            torch.cat([prevs[j][:, None], drafts], 1))
                top = model.lm_head(params, h)[:, i].argmax(-1).to(torch.int32)
                drafts[:, i] = top if i < accept else (top + 1) % cfg.vocab_size
            batch = verification.make_verify_batch(prevs[j], drafts, lengths)
            h, _ = model.decode_forward(params, caches[j], batch["tokens_in"])
            logits = model.lm_head(params, h)
            res, caches[j] = step(params, caches[j], batch)
            if not bool((res.n_commit == accept + 1).all()):
                raise AssertionError(f"mesh {label} reference round {r}: commits "
                                     f"{res.n_commit.tolist()}, want {accept + 1}")
            top2 = logits.topk(2, dim=-1).values
            parts.append({"batch": batch, "out_tokens": res.out_tokens,
                          "n_commit": res.n_commit, "gap": top2[..., 0] - top2[..., 1],
                          "logits": logits})
            prevs[j] = res.out_tokens[torch.arange(b, device="cuda"), res.n_commit - 1]
        merged = {k: torch.cat([p[k] for p in parts]).cpu()
                  for k in ("out_tokens", "n_commit", "gap", "logits")}
        merged["batch"] = {k: torch.cat([p["batch"][k] for p in parts]).cpu()
                           if torch.is_tensor(v) else v for k, v in parts[0]["batch"].items()}
        rec["rounds"].append(merged)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    torch.save(rec, work / f"{label}.ref.pt")
    print(f"mesh {label} reference: {cfg.num_layers} layers"
          f"{f' behind {stub.shape[1]} stub rows' if stub is not None else ''}, "
          f"{sum(p.numel() for p in params.parameters())} parameters on one rank, "
          f"{len(blocks)} blocks of {b} rows, {rec['seconds']:.2f} s; prefill logits std "
          f"{rec['prefill'].std().item():.4f}, max abs {rec['prefill'].abs().max().item():.4f}; "
          f"each row alone {rec['batch_noise']:.3e} from its block's", flush=True)
    del params, caches
    verify_attn.release_scratch()  # the 2045-row prefill's splits: 12 GiB
    return rec


def _mesh_rank_run(label: str, mesh, work: Path) -> dict:
    """One rank's part of a run: its pieces of the weights and the cache,
    the prefill and the reference's rounds on its rows through the mesh
    steps, each result against the reference's. Each round's logits come
    from the mesh's forward and head on the same cache and batch first, and
    their max abs difference from the reference's at each position is
    kept. A token that differs is a near tie where the reference's top-2
    gap there is at most twice that difference (so that difference alone
    can flip the argmax), and a mismatch otherwise; where a tie changes a
    row's commit count the rank commits the reference's count instead
    (``model.commit`` of its forward's cache), so every round of every row
    is held."""
    import torch.distributed as dist

    from repro_torch.core import verification
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model
    from repro_torch.sharding.policy import make_policy

    run = MESH_RUNS[label]
    B, max_len, seed = run.batch, run.max_len, run.seed
    cfg = _mesh_cfg(run.arch, run.layers)
    policy = make_policy(cfg, mesh)
    ctx = policy.ctx
    model = build_model(cfg)
    ref_rec = torch.load(work / f"{label}.ref.pt", weights_only=False)
    t0 = time.perf_counter()
    params = _mesh_weights(cfg, seed, policy)
    cache = policy.shard_cache(model.make_cache(B, max_len, device=mesh.device))
    rows = policy.shard_batch({"r": torch.arange(B)})["r"]
    stub = ref_rec["stub"]
    stub = None if stub is None else stub[rows].to(mesh.device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dist.barrier()
    _reset_launches()
    L.reset_moe_tally()
    t0 = time.perf_counter()
    prefill = verification.make_prefill_step(model, ctx=ctx, with_frontend=stub is not None)
    logits, cache, prev = prefill(params, cache, ref_rec["prompts"][rows].to(mesh.device), stub)
    step = verification.make_verify_step(model, ctx=ctx)
    out = {"label": label, "rank": mesh.rank, "coords": mesh.coords,
           "seq_shard_kv": ctx.seq_shard_kv,
           "cache_shapes": {k: list(v.shape) for k, v in cache.items() if k != "length"},
           "params": sum(p.numel() for p in params.parameters()),
           "prefill_max_abs": (logits.cpu() - ref_rec["prefill"][rows]).abs().max().item(),
           "rounds_max_abs": 0.0, "rounds": 0, "resynced": [], "ties": [], "mismatch": []}
    for r, want in enumerate(ref_rec["rounds"]):
        batch = policy.shard_batch({k: v.to(mesh.device) if torch.is_tensor(v) else v
                                    for k, v in want["batch"].items()})
        h, fwd_cache = model.decode_forward(params, cache, batch["tokens_in"], ctx=ctx)
        diff = (model.lm_head(params, h, ctx).cpu() - want["logits"][rows]).abs().amax(-1)
        out["rounds_max_abs"] = max(out["rounds_max_abs"], diff.max().item())
        res, cache = step(params, cache, batch)
        got_t, got_n = res.out_tokens.cpu(), res.n_commit.cpu()
        want_t, want_n, gap = want["out_tokens"][rows], want["n_commit"][rows], want["gap"][rows]
        out["rounds"] += 1
        if not torch.equal(got_n, want_n):
            out["resynced"].append(r)
            cache = model.commit(fwd_cache, want_n.to(mesh.device))
        for b in range(len(rows)):
            if torch.equal(got_t[b], want_t[b]):
                continue
            i = int((got_t[b] != want_t[b]).nonzero()[0])
            entry = {"round": r, "row": int(rows[b]), "pos": i, "gap": float(gap[b, i]),
                     "diff": float(diff[b, i]), "got": got_t[b].tolist(),
                     "want": want_t[b].tolist()}
            (out["ties"] if entry["gap"] <= 2 * entry["diff"] else out["mismatch"]).append(entry)
        del fwd_cache
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["init_seconds"] = init_s
    out["launches"] = {k: v for k, v in _launches().items() if v}
    out["moe_tally"] = L.moe_tally(mesh.device).tolist() if cfg.family == "moe" else None
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params, cache
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    return out


def mesh_rank_main(argv) -> int:
    """``--mesh-rank R --mesh-dir DIR --mesh-port PORT``: rank R of the mesh
    phase (four ranks, gloo on localhost), every run of MESH_RUNS, its
    results to DIR/rank<R>.json."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    args = dict(zip(argv[::2], argv[1::2]))
    rank, work = int(args["--mesh-rank"]), Path(args["--mesh-dir"])
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    M.init_process_group(rank, world, f"tcp://127.0.0.1:{args['--mesh-port']}",
                         timeout_s=MESH_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = M.make_debug_mesh(*MESH_SHAPE)
    results = [_mesh_rank_run(label, mesh, work) for label in MESH_RUNS]
    (work / f"rank{rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()
    return 0


def mesh_phase(records: dict) -> None:
    """The mesh phase: each run's reference on one rank in this process,
    then four ranks on the card (this script with --mesh-rank, gloo, a
    (2, 2) mesh of data x model), each holding only its pieces, held to the
    reference: the logits of the prefill and of every round within the
    run's ``logit_bound`` of one rank's (mamba2's rounds bit for bit), and
    greedy tokens and commits equal but at a near tie that the logits'
    difference explains (gaps printed; a tie's commit is re-synced to the
    reference's, so every round of every row is held). Prints each
    rank's parameters, cache pieces, peak memory, seconds and launches;
    each rank must launch its run's kernels (``MeshRun.kernels``): the
    shard form for granite-34b's sequence-sharded cache, the dense kernel
    on the rank's heads for the others (whisper's encoder and
    cross-attention its non-causal case), the SSD scan once per layer on
    the rank's heads for mamba2 and zamba2."""
    import shutil
    import socket
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    procs = []
    try:
        batch_noise = {}
        for label in MESH_RUNS:
            batch_noise[label] = _mesh_reference(label, work)["batch_noise"]
            _free_card(f"the mesh reference of {label}")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        world = MESH_SHAPE[0] * MESH_SHAPE[1]
        t0 = time.perf_counter()
        for r in range(world):
            log = open(work / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(r),
                 "--mesh-dir", str(work), "--mesh-port", str(port)],
                stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + MESH_TIMEOUT_S
        for p, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        wall = time.perf_counter() - t0
        failed = [r for r, (p, _) in enumerate(procs) if p.poll() != 0]
        if failed:
            for r in failed:
                print(f"mesh rank {r} log:\n{(work / f'rank{r}.log').read_text()[-4000:]}",
                      flush=True)
            raise AssertionError(f"mesh ranks {failed} failed or timed out")
        results = [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]
        print(f"mesh: {world} ranks on {torch.cuda.get_device_name(0)}, {wall:.2f} s from spawn "
              f"to the last exit", flush=True)
        mesh_launches = collections.Counter()
        for i, (label, run) in enumerate(MESH_RUNS.items()):
            n_layers = _mesh_cfg(run.arch, run.layers).num_layers
            for res in (rk[i] for rk in results):
                print(f"mesh {label} rank {res['rank']} {res['coords']}: "
                      f"{res['params']} parameters, cache pieces {res['cache_shapes']}, peak "
                      f"{res['peak_gib']:.2f} GiB, init {res['init_seconds']:.2f} s, run "
                      f"{res['seconds']:.2f} s, {res['rounds']} rounds (commits re-synced in "
                      f"rounds {res['resynced']}), logits max abs from one rank's: prefill "
                      f"{res['prefill_max_abs']:.3e}, rounds {res['rounds_max_abs']:.3e} "
                      f"(bound {run.logit_bound}; each row alone {batch_noise[label]:.3e} from "
                      f"its block's on one rank), launches {res['launches']}, moe tally "
                      f"{res['moe_tally']}", flush=True)
                for tie in res["ties"]:
                    print(f"mesh {label} near tie: {json.dumps(tie)}", flush=True)
                worst = max(res["prefill_max_abs"], res["rounds_max_abs"])
                if not worst <= run.logit_bound or res["rounds"] != run.rounds:
                    raise AssertionError(f"mesh {label} rank {res['rank']}: logits {worst} from "
                                         f"one rank's, bound {run.logit_bound}, or "
                                         f"{res['rounds']} of {run.rounds} rounds held")
                if res["mismatch"]:
                    raise AssertionError(f"mesh {label} rank {res['rank']}: tokens differ from "
                                         f"one rank's beyond a near tie: {res['mismatch']}")
                launches = res["launches"]
                mesh_launches.update(launches)
                missing = [name for name in run.kernels if not launches.get(name)]
                if missing:
                    raise AssertionError(f"mesh {label} rank {res['rank']}: {missing} not "
                                         f"launched on the mesh path ({launches})")
                if res["seq_shard_kv"] != ("verify_attention_packed_shard" in run.kernels):
                    raise AssertionError(f"mesh {label}: seq_shard_kv {res['seq_shard_kv']}")
                if "ssd_scan" in run.kernels and launches["ssd_scan"] != n_layers:
                    raise AssertionError(f"mesh {label}: ssd_scan launched "
                                         f"{launches['ssd_scan']} times, want one a layer "
                                         f"({n_layers})")
                if res["moe_tally"] is not None and res["moe_tally"][1]:
                    raise AssertionError(f"mesh {label}: the dropless twin dropped "
                                         f"{res['moe_tally'][1]} assignments")
            if label == "mamba2":  # only the scan sees fewer heads: bit-equal expected
                worst = [max(rk[i][k] for rk in results)
                         for k in ("prefill_max_abs", "rounds_max_abs")]
                print(f"mesh mamba2: the ranks' logits bit-equal to one rank's: "
                      f"{max(worst) == 0.0} (largest difference: prefill {worst[0]:.3e}, "
                      f"rounds {worst[1]:.3e})", flush=True)
                if worst[1] != 0.0:
                    raise AssertionError(f"mesh mamba2: the rounds' logits {worst[1]} from one "
                                         "rank's, bit-equal expected")
        for name in ("verify_attention_packed_shard", "verify_attention_packed",
                     "verify_attention_packed_noncausal", "ssd_scan"):
            records[name].setdefault("launches_by_path", {})["mesh"] = mesh_launches[name]
        # the shard form runs on the mesh path only
        records["verify_attention_packed_shard"]["launches"] = mesh_launches[
            "verify_attention_packed_shard"]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(work, ignore_errors=True)


def build_kernels() -> None:
    """Phase 1: build every kernel of the paths from the checkout's sources,
    one nvcc per source, all started together."""
    from repro_torch.kernels import build

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    for name, res in results.items():
        BUILD_LOGS[name] = res.log
        print(f"build: {name} {res.seconds:.2f} s -> {res.path}", flush=True)
        for ln in res.log.splitlines():
            if "registers" in ln or "smem" in ln or "error" in ln.lower() or "spill" in ln:
                print("  ptxas:", ln.strip())


def _free_card(what: str) -> None:
    """After ``del`` of a phase's bundle: collect the reference cycles that
    still hold its tensors (Systems, sessions and closures), return the
    cached blocks to the card, restart the peak count, and print what
    stays allocated."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"freed {what}: device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved", flush=True)


def _phase(name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 - fails when run outside the checkout

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    records = {
        name: {"name": name, "route": "cuda", "source": SOURCE_OF[name], "replaces": REPLACES[name],
               "launches": 0, "max_abs_err": 0.0}
        for name in REPLACES
    }
    _phase("build", build_kernels)
    _phase("kernels", lambda: check_kernels(records))
    # the launcher's training runs first, on a card no serve bundle has
    # used: they are processes of their own, which cannot use the blocks
    # this process's allocator keeps reserved (tens of GB by the end of the
    # serve phases, pinned by small live tensors even after empty_cache);
    # train qwen2 runs last in this process for the same reason (it leaves
    # ~38 GB reserved, which the spawned workers of the serve phases need)
    _free_card("the kernels' inputs")
    # the simulator's rows run on the host's cores beside the device phases
    sims = start_sim_fig4()
    _phase("train whisper", lambda: train_whisper(records))
    prompts = np.random.default_rng(2).integers(0, 151936, size=(6, 200)).astype(np.int32)

    qwen = _phase("init qwen2-1.5b", lambda: full_width_bundle("qwen2-1.5b"))
    per_slot, engine_tps = {}, {}
    # each path: (label, kv_dtype, kernel entries it must launch)
    for label, kv_dtype, path in (("bf16", "bf16", BF16_PATH), ("int8", "int8", INT8_PATH)):
        spec = serve_spec("engine", kv_dtype=kv_dtype)
        served = _phase(f"serve {label}", lambda: serve(
            label, records, qwen, prompts, spec=spec, path=path))
        per_slot[label] = served["per_slot"]
        engine_tps[kv_dtype] = served["tokens_per_s"]
        _phase(f"check {label}", lambda: check(label, qwen, prompts, served,
                                               spec=serve_spec("reference", kv_dtype=kv_dtype)))
    ratio = per_slot["int8"] / per_slot["bf16"]
    print(f"pool: bytes_per_slot int8 {per_slot['int8']} bf16 {per_slot['bf16']} "
          f"ratio {ratio:.4f}", flush=True)
    if ratio > 0.51:
        raise AssertionError(f"int8 pool holds {ratio:.4f} of bf16's bytes per slot (> 0.51)")

    served = _phase("serve dense gather", lambda: serve_dense_gather(records, qwen, prompts))
    _phase("check dense gather", lambda: check("dense gather", qwen, prompts, served,
                                               spec=serve_spec("reference")))
    _phase("sampler", lambda: check_sampler(qwen, prompts[0]))
    _phase("serve sample", lambda: serve_sample(records, qwen, prompts))
    q8, _ = _phase("quantize 8", lambda: quantize_bundle(qwen, 8))
    served = _phase("serve bits8", lambda: serve(
        "bits8", records, q8, prompts, spec=serve_spec("engine", bits=8), path=BF16_PATH))
    _phase("check bits8", lambda: check("bits8", q8, prompts, served,
                                        spec=serve_spec("reference", bits=8)))
    del q8
    _phase("serve fleet", lambda: serve_fleet(records, qwen, prompts))

    # the engine serves' 6 prompts and 2 more
    prompts8 = np.concatenate([prompts, np.random.default_rng(3).integers(
        0, 151936, size=(2, 200)).astype(np.int32)])
    for label, kv_dtype in (("cluster", "bf16"), ("cluster int8", "int8")):
        served = _phase(f"serve {label}", lambda: serve_cluster(
            label, records, qwen, prompts8, kv_dtype=kv_dtype, engine_tps=engine_tps[kv_dtype]))
        if label == "cluster":
            cluster = served  # the remote phase's yardstick
        _phase(f"check {label}", lambda: check(
            label, qwen, prompts8, served, spec=serve_spec("reference", kv_dtype=kv_dtype,
                                                           devices=8)))
    served = _phase("serve transport", lambda: serve_transport(
        "transport", records, qwen, prompts, spec=serve_spec("transport"),
        engine_tps=engine_tps["bf16"]))
    _phase("check transport", lambda: check("transport", qwen, prompts, served,
                                            spec=serve_spec("reference")))
    _phase("serve transport fleet", lambda: serve_transport_fleet(
        records, qwen, prompts, engine_tps=engine_tps["bf16"]))
    remote = _phase("serve remote", lambda: serve_remote(records, qwen, prompts8,
                                                         cluster=cluster))
    _phase("serve remote spawned", serve_remote_spawned)
    _phase("serve remote chaos", lambda: serve_remote_chaos(records, qwen, prompts8,
                                                            cluster=cluster, remote=remote))
    _phase("serve chaos spawned", lambda: serve_chaos_spawned(records))
    del qwen
    _free_card("qwen2-1.5b")

    m2 = _phase("init mamba2-370m", lambda: full_width_bundle("mamba2-370m"))
    m2_prompts = prompts % m2.target_cfg.vocab_size
    # one scan per layer per prefill: 6 target prefills of 48 layers, 6 draft
    # prefills of 1 layer
    path = {"ssd_scan": 6 * m2.target_cfg.num_layers + 6 * m2.draft_cfg.num_layers}
    served = _phase("serve ssm", lambda: serve(
        "ssm", records, m2, m2_prompts, spec=serve_spec("engine", "mamba2-370m"), path=path))
    _phase("check ssm", lambda: check("ssm", m2, m2_prompts, served,
                                      spec=serve_spec("reference", "mamba2-370m")))
    del m2
    _free_card("mamba2-370m")

    # the draft: the target's first 6 SSD layers and its shared block (one
    # application, so the draft attends too)
    zb = _phase("init zamba2-1.2b", lambda: full_width_bundle("zamba2-1.2b", draft_layers=6))
    zb_prompts = prompts % zb.target_cfg.vocab_size
    path = {"verify_attention_packed": None,
            "ssd_scan": 6 * zb.target_cfg.num_layers + 6 * zb.draft_cfg.num_layers}
    served = _phase("serve hybrid", lambda: serve(
        "hybrid", records, zb, zb_prompts, spec=serve_spec("engine", "zamba2-1.2b", draft_layers=6),
        path=path))
    _phase("check hybrid", lambda: check("hybrid", zb, zb_prompts, served,
                                         spec=serve_spec("reference", "zamba2-1.2b",
                                                         draft_layers=6)))
    del zb
    _free_card("zamba2-1.2b")

    # the moe family: granite-moe-3b-a800m (G = 3) as registered, then its
    # dropless twin against the reference
    gm = _phase("init granite-moe-3b-a800m", lambda: full_width_bundle("granite-moe-3b-a800m"))
    gm_prompts = prompts % gm.target_cfg.vocab_size
    _phase("serve moe", lambda: serve_moe("moe", records, gm, gm_prompts, max_new=32))
    _phase("check moe", lambda: check_moe("moe", records, gm, gm_prompts, max_new=32))
    del gm
    _free_card("granite-moe-3b-a800m")

    pair = _phase("init llama pair", paper_pair_bundle)
    paper_prompts = np.random.default_rng(4).integers(
        0, pair.target_cfg.vocab_size, size=(6, 200)).astype(np.int32)
    # two random models of different widths essentially never agree, so
    # this serve need not accept a draft (its acceptance is printed)
    served = _phase("serve paper", lambda: serve(
        "paper", records, pair, paper_prompts, spec=paper_spec("engine"), path=BF16_PATH,
        need_accepted=False))
    _phase("check paper", lambda: check("paper", pair, paper_prompts, served,
                                        spec=paper_spec("reference"), witness=True))
    _phase("calibrate h100", lambda: calibrate_h100(pair))
    del pair
    _free_card("the llama pair")

    # qwen3-moe-30b-a3b (G = 8) on a card emptied of the earlier bundles
    qm = _phase("init qwen3-moe-30b-a3b", lambda: full_width_bundle("qwen3-moe-30b-a3b"))
    print(f"init qwen3-moe-30b-a3b: {sum(p.numel() for p in qm.target_params.parameters())} "
          f"parameters ({qm.target_cfg.param_count()} by the config), device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    _phase("serve moe 30b", lambda: serve_moe("moe 30b", records, qm, prompts, max_new=16))
    _phase("check moe 30b", lambda: check_moe("moe 30b", records, qm, prompts, max_new=16))
    _phase("calibrate moe 30b", lambda: calibrate_moe(qm))
    del qm
    _free_card("qwen3-moe-30b-a3b")

    # the vlm family (llava-next-mistral-7b, G = 4) served as its backbone,
    # as the JAX System serves it, then its prefill behind the stub patches
    vl = _phase("init llava-next-mistral-7b", lambda: init_bundle("llava-next-mistral-7b"))
    vl_prompts = prompts % vl.target_cfg.vocab_size
    serve_dense_config("vlm", records, vl, vl_prompts, max_new=32)
    _phase("prefix vlm", lambda: prefix_vlm(vl, vl_prompts))
    del vl
    _free_card("llava-next-mistral-7b")
    # the last dense configs: phi3-mini-3.8b (head_dim 96), granite-34b (the
    # gelu MLP, MQA at G = 48; ~68 GB of weights) and qwen1.5-32b at a depth
    # cut of 48 of its 64 layers (70.4 GB of weights at full depth do not fit
    # beside the draft, the f32 heads and the pool; PERF.md section 4)
    for label, arch, layers, max_new in (("phi3", "phi3-mini-3.8b", 0, 32),
                                         ("granite-34b", "granite-34b", 0, 16),
                                         ("qwen1.5-32b", "qwen1.5-32b", 48, 16)):
        dc = _phase(f"init {arch}", lambda: init_bundle(arch, layers))
        serve_dense_config(label, records, dc, prompts % dc.target_cfg.vocab_size,
                           max_new=max_new)
        del dc
        _free_card(arch)
    # the encdec family (whisper-tiny at full width) and the port's
    # checkpoints of its params
    wh = _phase("init whisper-tiny", init_whisper)
    _phase("encdec", lambda: serve_encdec(records, *wh))
    _phase("checkpoint", lambda: checkpoint_phase(wh[1]))
    del wh
    _free_card("whisper-tiny")
    # serving across a device mesh: four ranks on the card
    _phase("mesh", lambda: mesh_phase(records))
    _free_card("the mesh phase")
    _phase("sim fig4", lambda: sim_fig4(sims))
    _phase("tune", lambda: tune_on_card(records))
    _phase("cli", cli_on_card)
    _free_card("the serve phases")
    _phase("train qwen2", lambda: train_qwen2(records))
    _free_card("train qwen2")
    _phase("train mamba2", lambda: train_ssm(records, "train mamba2", "mamba2-370m"))
    _free_card("train mamba2")
    _phase("train zamba2", lambda: train_ssm(records, "train zamba2", "zamba2-1.2b"))

    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv[1:]:
        sys.exit(worker_main(sys.argv[1:]))
    sys.exit(mesh_rank_main(sys.argv[1:]) if "--mesh-rank" in sys.argv[1:] else main())

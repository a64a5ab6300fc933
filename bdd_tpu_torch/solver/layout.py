"""Geometry and state of the bucketed uniform backend, as torch tensors.

Counterparts of ``BucketGeom``, ``UniformGeom``, ``UniformState`` and
``UniformHost`` (bdd_tpu/solver/uniform.py:77-108, 665-697), of
``NativeHost.make_uniform_host`` (bdd_tpu/native.py:326-382) and of the column
packing ``pack_uniform_host`` (uniform.py:863-1075).

All building runs on the host in numpy. Tensors move to the device once, at
build time, in the form the sweep kernels read: the arc geometry as one, two
or four bytes per arc (:func:`encode_arcs`), one flat buffer over all buckets for every
per-layer quantity (the flat slot order of ``UniformGeom.sizes``), the tables
of the buckets for the launches of a half-sweep (:class:`LaunchPlan`), int64
variable ids (torch's index dtype), and the float dtype of the solve. Nothing
is cast, concatenated or validated again per iteration.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ARC_INTERNAL = 0
ARC_TOP = 1
ARC_BOT = 2

# Column-packing cost model of the JAX package, tuned on a TPU; kept
# unchanged so the port builds the same layouts as the reference.
PACK_LAMBDA = 128
PACK_H_CAP = 256

_NODE_KEYS = ("node_valid", "lo_kind", "lo_slot", "hi_kind", "hi_slot")
_LAYER_KEYS = ("layer_valid", "layer_var", "alpha", "layer_bdd")


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``, with the card's index filled in (so
    it compares equal to its tensors' device); raises when CUDA is asked for
    and there is none (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# Arc records. Per (hop, column) one record of record_bytes(P) bytes:
# [lo arc of slot 0..P-1, hi arc of slot 0..P-1, zero padding up to 4 bytes].
# Narrow buckets (P <= NARROW_P) take one byte an arc: kind | slot << 2 |
# flag << 7 (kind in 2 bits, slot in 5). Wide buckets (NARROW_P < P <= WIDE_P)
# take two bytes an arc, a little-endian uint16: kind | slot << 2 | flag << 15
# (slot in 13 bits). Huge buckets (P > WIDE_P) take four bytes an arc, a
# little-endian int32: kind | slot << 2 | flag << 30 (slot in 28 bits; bit 31
# stays clear, so an int32 decode never sees a sign bit). The flags sit at the
# same arcs in every form: on a lo arc node_valid of its slot, on arc P (the
# first hi arc) layer_valid, and on arc P + 1 (the second hi arc; a padding
# byte when P = 1) the root row.
# WIDE_P is the widest bucket of the wide sweep body and of the two-byte
# record: one warp's two rows and one ring slot of P = 8192 float64 values take
# 229,440 of the 232,448 bytes of shared memory a block may opt into
# (:func:`wide_warp_bytes`). Wider buckets run the huge body, a block a
# column, and so do most wide buckets from HUGE_FROM on, on their two-byte
# records (:func:`body_of`).
NARROW_P = 32
WIDE_P = 8192
_FLAG_SHIFT = {1: 7, 2: 15, 4: 30}
_SLOT_MASK = {1: 31, 2: 8191, 4: (1 << 28) - 1}
_WORD = {1: np.uint8, 2: np.dtype("<u2"), 4: np.dtype("<i4")}


def arc_bytes(P: int) -> int:
    """Bytes of one arc in a bucket of width P."""
    return 1 if P <= NARROW_P else (2 if P <= WIDE_P else 4)


def record_bytes(P: int) -> int:
    return max(4, 2 * P * arc_bytes(P))


def encode_arcs(node_valid, lo_kind, lo_slot, hi_kind, hi_slot, layer_valid, roots) -> np.ndarray:
    """uint8 records [H, B, record_bytes(P)] of the [H, P, B] arc arrays and
    the [H, B] layer masks; raises on values the record cannot hold."""
    H, P, B = np.shape(node_valid)
    width = arc_bytes(P)
    word = _WORD[width]
    shift, mask = _FLAG_SHIFT[width], _SLOT_MASK[width]
    rec = np.zeros((H, B, record_bytes(P) // width), dtype=word)
    for off, kind, slot in ((0, lo_kind, lo_slot), (P, hi_kind, hi_slot)):
        kind, slot = np.asarray(kind), np.asarray(slot)
        if kind.size and (kind.min() < 0 or kind.max() > ARC_BOT
                          or slot.min() < 0 or slot.max() > mask):
            raise ValueError(f"arc kind outside 0..2 or slot outside 0..{mask}")
        rec[:, :, off:off + P] = (kind | (slot << 2)).astype(word).transpose(0, 2, 1)
    rec[:, :, :P] |= np.asarray(node_valid, dtype=word).transpose(0, 2, 1) << shift
    rec[:, :, P] |= np.asarray(layer_valid, dtype=word) << shift
    rec[:, :, P + 1] |= np.asarray(roots, dtype=word) << shift
    return rec.view(np.uint8)


@dataclasses.dataclass(frozen=True)
class BucketGeom:
    """Static geometry of one (width P, depth H) bucket of B columns.

    Frontier tensors (cft, cfr) of a bucket are [H, P, B] everywhere in the
    port. In the flat buffers a narrow bucket stores them so, B innermost; a
    wide bucket (P > NARROW_P) stores [H, B, P], the slot innermost, so that
    the row of a column and hop is one contiguous run for the warp that owns
    the column. ``UniformGeom.per_bucket_nodes`` gives the [H, P, B] view of
    either and ``UniformGeom.flatten_nodes`` lays per-bucket tensors back.

    ``arcs`` holds the arc records (:func:`encode_arcs`; one, two or four
    bytes an arc by P), the only stored form of the arc geometry and layer masks;
    kernels and twins read these bytes. The [H, P, B] / [H, B] properties
    below decode them with shifts and masks on every access (tests and
    one-off host code; the twins decode once per call through
    :meth:`decode`). ``arcs`` and ``alpha`` are views into the flat buffers
    of the owning ``UniformGeom``.

    ``packed`` (column packing): columns hold several BDDs, and ``roots``
    marks the rows where a new BDD's root (slot 0) starts, where the forward
    frontier restarts and the lower bound reads root costs. Unpacked, the
    roots are the valid layers of row 0."""

    P: int
    arcs: torch.Tensor  # uint8 [H, B, record_bytes(P)]
    layer_var: torch.Tensor  # int64 [H, B] (pad -> V sentinel)
    alpha: torch.Tensor  # float [H, B]
    packed: bool = False

    @property
    def H(self) -> int:
        return self.arcs.shape[0]

    @property
    def B(self) -> int:
        return self.arcs.shape[1]

    def _words(self):
        """(arcs [H, B, >= 2P] as integers, flag threshold, slot mask): the
        bytes themselves for narrow buckets, the uint16 arcs widened to int32
        for wide ones, the int32 arcs (bit 31 clear) for huge ones."""
        width = arc_bytes(self.P)
        if width == 1:
            return self.arcs, 128, _SLOT_MASK[1]
        if width == 2:
            return self.arcs.view(torch.int16).to(torch.int32) & 0xFFFF, 32768, _SLOT_MASK[2]
        return self.arcs.view(torch.int32), 1 << 30, _SLOT_MASK[4]

    def decode(self):
        """(node_valid bool, lo_kind, lo_slot, hi_kind, hi_slot; uint8 for
        narrow buckets, int32 for wider ones), each [H, P, B], from the
        records."""
        P = self.P
        w, flag, mask = self._words()
        lo = w[:, :, :P].transpose(1, 2)
        hi = w[:, :, P:2 * P].transpose(1, 2)
        return lo >= flag, lo & 3, (lo >> 2) & mask, hi & 3, (hi >> 2) & mask

    @property
    def node_valid(self) -> torch.Tensor:  # bool [H, P, B]
        return self.decode()[0]

    @property
    def lo_kind(self) -> torch.Tensor:  # int32 [H, P, B]
        return self.decode()[1].to(torch.int32)

    @property
    def lo_slot(self) -> torch.Tensor:
        return self.decode()[2].to(torch.int32)

    @property
    def hi_kind(self) -> torch.Tensor:
        return self.decode()[3].to(torch.int32)

    @property
    def hi_slot(self) -> torch.Tensor:
        return self.decode()[4].to(torch.int32)

    def _flag(self, arc: int) -> torch.Tensor:  # bool [H, B]
        """The flag of one arc, from its top byte: bit 7 of it in the one- and
        two-byte forms, bit 6 in the four-byte form (bit 7 there is clear)."""
        width = arc_bytes(self.P)
        return self.arcs[:, :, width * arc + width - 1] >= (64 if width == 4 else 128)

    @property
    def layer_valid(self) -> torch.Tensor:  # bool [H, B]
        return self._flag(self.P)

    @property
    def roots(self) -> torch.Tensor:  # bool [H, B]
        return self._flag(self.P + 1)

    @property
    def root_mask(self) -> Optional[torch.Tensor]:
        """The packed layout's segment starts; None for one BDD per column."""
        return self.roots if self.packed else None


@dataclasses.dataclass(frozen=True)
class ExchangeIndex:
    """Per-variable slot grouping for the delta consensus, built once on the
    host: a segment reduction over ``order`` (valid slots sorted by variable,
    stable) with ``lengths`` per variable, and a gather back through ``ids``.
    Deterministic on every device: no atomics. ``lengths`` is checked here,
    once, so the reductions run unchecked and never wait for the host."""

    ids: torch.Tensor  # int64 [E] variable per flat slot, V at invalid slots
    order: torch.Tensor  # int64 [Ev] valid flat slots sorted by variable
    lengths: torch.Tensor  # int64 [V] valid slots per variable
    valid: torch.Tensor  # bool [E] layer_valid, flat
    segments: torch.Tensor  # int64 [V + 1]: lengths and an empty segment for V


# ------------------------------------------------------------- launch plan
# Columns a block works on (one thread each: whole warps), by the launch's
# total column count.
TILE_SMALL, TILE_LARGE = 32, 64
TILE_SWITCH = 32768  # total columns above which a block takes the large tile
MAX_STAGES = 8  # hops a thread keeps in flight
STAGE_COLUMNS = 110_000  # columns x stages to aim for: ~2.3 MB on the wire
MIN_STAGES = 3
SMEM_BUDGET = 48 * 1024  # static limit of dynamic shared memory a block
LAYER_ROWS = 6  # lo hi din_lo din_hi alpha omega
TABLE_COLUMNS = 8  # P H B first_block row_off node_off arc_off stages
ARC_ALIGN = 16  # bytes; bucket offsets into the records keep 16-byte copies aligned


WIDE_WARPS = 8  # columns (one warp each) a block of the wide kernel takes at most
WIDE_STAGES = 1  # hops a warp of the wide kernel copies ahead
WIDE_SCALARS = 8  # values a ring slot keeps for the layer (6 used)
SM_COUNT = 132  # H100 SXM; a plan for a card reads the card's own count (:func:`sm_count`)
MAX_DYNAMIC_SMEM = 227 * 1024  # the most a block may opt into
SM_SMEM = 228 * 1024  # shared memory of one SM, over its blocks
BLOCK_SMEM_RESERVED = 1024  # what the card keeps of it for every resident block
# Threads of a block (a column) of the huge body, at most; the plan gives the
# shared-memory form fewer only where several of its blocks reside on an SM,
# as many as its columns ask for and its shared memory lets fit
# (:func:`_huge_plan`: 512 for the 256 columns of P = 8,192 rows, two blocks
# an SM; 1,024 wherever a P = 16,384 bucket is in the table, since one such
# block fills an SM's shared memory; the cluster body's the same way, over
# its blocks, :func:`_cluster_plan`). The L2 form runs 1,024: at 132 columns of P = 16,384 its half-sweeps
# took 1.44 / 1.54 ms in float32 and 2.05 / 1.78 ms in float64, against 2.29
# / 2.69 and 2.92 / 2.86 ms at 512 threads (chip_smoke.py, phase 6, "[depth]",
# NVIDIA H100 80GB HBM3 at 700 W; 256 threads were about twice as slow again).
# Only the tests and chip_smoke.py's timing variants set other counts
# (``dataclasses.replace`` of a plan's launch).
HUGE_THREADS = 1024
HUGE_MAX_CODE = 0x7FFD  # a slot code holds slots below this (uniform_sweep.cu, CODE_ZERO)
HUGE_SCALARS = 8  # values a ring slot of the huge body keeps for the layer (6 used)
# Hops the shared-memory huge body's ring form copies ahead (each hop's arc
# record, frontier row and layer values into a ring of HUGE_RING_HOPS + 1
# stages in shared memory): the form a launch takes where no bucket of its
# huge table is wider than its threads, one slot a thread
# (the second of its launch's own integers, ``BodyLaunch.own``;
# uniform_sweep.cu, sweep_huge_ring_kernel).
# Measured over 1 to 4 hops on the gap_d60900 layout (chip_smoke.py
# --huge-ring; PERF.md section 6). HUGE_RING_MAX: the deepest the kernel
# takes.
HUGE_RING_HOPS = 3
HUGE_RING_MAX = 8
# Wide buckets from HUGE_FROM up to WIDE_P slots run the huge body (its
# shared-memory form, on their two-byte records), except float32 buckets
# narrower than HUGE_FROM_F32_MANY over more than HUGE_F32_BLOCKS_SM columns
# an SM: there a huge block has 128 threads or fewer and the wide body's
# warp a column is faster. Measured on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py, "[huge] crossover" of phase 6 and of --huge-split; PERF.md
# section 6), forward + backward, wide / huge body, ms, knapsack rows of 32
# variables: over 256 columns, at 256 slots 0.114 / 0.132 in float32 and
# 0.172 / 0.184 in float64, at 512 0.178 / 0.182 and 0.271 / 0.240, at
# 1,024 0.299 / 0.223 and 0.469 / 0.278, at 8,192 3.724 / 0.811 and 5.606 /
# 1.000; in float32 at 1,024 slots over 512 columns 0.306 / 0.277, over
# 1,024 0.353 / 0.479, over 2,048 0.697 / 0.882; at 2,048 slots over 1,024
# columns 1.100 / 0.872, over 2,048 2.176 / 2.196; at 4,096 over 2,048 8.060
# / 3.703; in float64 the huge body leads at every one of these. The rule
# holds for the huge table as a whole, which one launch runs at one thread
# count and one block's shared memory (:func:`_route_huge_table`): routed
# float32 buckets below HUGE_FROM_F32_MANY go back to the wide body where the
# table's columns are more than HUGE_F32_BLOCKS_SM an SM, or more than its
# widest bucket's shared memory lets reside.
HUGE_FROM = 1024
HUGE_FROM_F32_MANY = 2048
HUGE_F32_BLOCKS_SM = 4
# Rows past a block's shared memory (:func:`huge_fits`) may run the cluster
# body where a cluster of CLUSTER_SIZES blocks holds them (:func:`cluster_fits`;
# the route takes it where their columns are many, L2_FROM_SPLIT below, and
# for float32 rows a block holds over few columns, BLOCK_ROWS_CLUSTER): a
# cluster of C blocks a column, each block a share of ceil(P / C) slots of
# the rows in its shared memory, the rest reached through distributed shared
# memory. 16 is a non-portable cluster size, which the kernels allow. Its
# slot codes take four bytes (two 16-bit children) where the table's widest
# bucket is below CLUSTER_MAX_P (uniform_sweep.cu, CL_MAX_P) and eight (two
# 32-bit children) past it (:func:`cluster_code_bytes`), so only shared
# memory bounds the width: a cluster of 16 holds up to 309,312 slots in
# float32 and 231,552 in float64 (every power-of-two bucket up to 262,144 /
# 131,072); the L2 body takes the rest, and in float64 what only a cluster
# of 16 holds (CLUSTER_ROUTED). Many columns of 32,768 slots and more run
# faster on it than on the L2 body (L2_FROM_SPLIT), and so do clusters of 16
# in float32 (CLUSTER_ROUTED) and the eight-byte codes (132 float32 rows
# of 65,536 slots, 4.20 ms forward against 5.75; PERF.md section 6). The
# plan's cluster size, one rule for both precisions: on an NVIDIA H100 80GB
# HBM3 (700 W) the card holds 66 / 30 / 15 / 7 clusters of 2 / 4 / 8 / 16
# blocks of one block an SM, and the plan's rule (fewest waves of clusters
# times slots a thread, then the smallest C) picked the fastest C measured
# in both precisions: C = 2 on 132 rows of 32,768 slots (C = 16, 2.1-4.2x
# slower there), C = 8 at 1,024 threads on 8 rows of 65,536 (the float32
# forward / backward / run 0.513 / 0.427 / 0.384 ms, float64 0.763 / 0.512
# / 0.404; C = 16 at 1,024 threads, two waves of 7 clusters, 1.4-1.5x
# slower; at 512 threads, one wave, float32 within 3% and float64's
# forward 15% slower: its compare-and-swap into peers, 15 of 16 arrivals).
CLUSTER_SIZES = (2, 4, 8, 16)
# The largest cluster whose rows the route gives the cluster body, by the
# values' bytes (:func:`body_of`). Rows that only a cluster of 16 holds
# (past 154,656 float32 / 115,776 float64 slots) keep it in float32, where
# its forward leads the L2 body's over the columns the route gives it such
# rows (G below 4, 34 columns and more: 66 rows of 262,144 slots 9.16 / 8.35
# / 8.25 ms forward / backward / run against the L2 body's 11.16 / 7.17 /
# 3.75 at G = 2, 132 rows 17.13 / 15.60 / 15.33 against 22.06 / 14.35 / 7.49
# at G = 1; also at G = 4, 33 rows, 4.59 / 4.19 against 5.64 / 3.57),
# and take the L2 body in float64, which led it in all three entries at
# every column count measured (131,072 slots over 1 to 132 columns; 66 rows
# 7.64 / 4.96 / 2.60 against 9.55 / 5.92 / 4.39 ms, 132 rows 15.06 / 9.82 /
# 5.18 against 18.19 / 11.20 / 8.38; NVIDIA H100 80GB HBM3, 700 W,
# chip_smoke.py --huge-split route; PERF.md section 6).
# A plan built on the cluster body (:func:`build_plan`) still reaches C = 16
# in both precisions.
CLUSTER_ROUTED = {4: 16, 8: 8}
CLUSTER_MAX_P = 0xFFFD  # four-byte slot codes hold slots below this
# Clusters are placed within one GPC (graphics processing cluster), so the
# card holds fewer large clusters at once than its SMs alone would
# (:func:`cluster_occupancy`). The SMs of an H100 SXM's GPCs as the card's
# answers above imply them (132 SMs; at one block an SM they give exactly
# 66 / 30 / 15 / 7): the estimate off the card.
GPC_SMS = (18, 18, 18, 18, 18, 16, 16, 10)
# The L2 body (rows past what the route's clusters hold, CLUSTER_ROUTED, rows
# past WIDE_P over few columns, every run of rows the cluster body sweeps, and
# where a plan is built so) spreads each column over G blocks (the first of
# its launch's own integers, ``BodyLaunch.own``) that
# meet at a hop barrier of the column in device memory (uniform_sweep.cu,
# the L2 section). Block g of a column owns the chunks of L2_CHUNK slots (a
# warp's) whose index is g modulo G (:func:`l2_slots`). The plan takes G from
# the blocks the card holds at once over the L2 columns
# (:func:`choose_l2_split`); where G > 1 a cooperative launch places every
# block at once or is refused. G = 1 is a block a column.
L2_CHUNK = 32
L2_MAX_SPLIT = 256  # blocks a column the kernel takes at most
# Rows past WIDE_P take their body by their columns as well as their width
# (:func:`_route_by_columns`): the half-sweeps of a bucket that a cluster or
# a block holds take the L2 body where the L2 table's G, counted with the
# bucket in it, is at least L2_FROM_SPLIT (float32 rows a block holds the
# cluster body there, while one wave of clusters holds them:
# BLOCK_ROWS_CLUSTER); the run-only entry takes the L2 body for every bucket
# that a cluster holds but a block does not (:func:`route`). Measured on
# an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --huge-split route; PERF.md
# section 6), warm ms forward / backward, the cluster body at the plan's
# C against the L2 body at the plan's G, knapsack rows of 48 variables: at G =
# 4 (33 columns) the L2 body led on 5 of 6 layouts (32,768 slots 0.72 / 0.65
# against 0.64 / 0.50 in float32, 0.96 / 0.83 against 0.86 / 0.63 in float64;
# 65,536 slots 1.64 / 1.54 against 1.44 / 0.85 and 2.19 / 1.60 against 1.99 /
# 1.31; 131,072 float64 slots 4.83 / 2.97 against 3.89 / 2.56), not on
# 262,144 float32 slots (4.59 / 4.21 against 5.64 / 3.60); at G = 8 to 132 (1
# to 16 columns) on every layout but 8 columns of 32,768 float32 slots (0.33
# / 0.29 against 0.33 / 0.30); at G = 2 (66 columns) and 1 (132) the cluster
# body led (32,768 float32 slots 0.77 / 0.74 against 1.44 / 0.85, and 1.52 /
# 1.45 against 2.97 / 1.94). One rule for both precisions. The L2 run led on
# every layout, 1.3-4.8x (132 rows of 32,768 float64 slots: 1.34 ms against
# 1.81). Rows a block holds (knapsack48's 16,384 slots in both precisions,
# padded to 29,016 in float32 and 19,316 in float64), warm ms forward +
# backward, the shared-memory huge body against the L2 body at the plan's G:
# the L2 body led at G = 4 to 29 (1 to 33 columns) on every layout, 1.7-4.1x
# (over 33 columns 16,384 slots 1.37 against 0.77 in float32, 1.52 against
# 0.91 in float64; 29,016 slots 2.50 against 1.08; 19,316 slots 1.86
# against 1.10), at G = 2 (66 columns) on three by 5-22% and not on 19,316
# float64 slots (1.93 against 1.96), and the huge body led at G = 1 (132
# columns: 16,384 slots 1.53 against 2.15 and 1.86 against 3.32): the same
# threshold, as for rows a cluster holds.
L2_FROM_SPLIT = 4
# Float32 rows that a block holds (past WIDE_P), where the rule by columns
# gives them the L2 body, take the cluster body instead while the card holds
# a cluster of BLOCK_ROWS_CLUSTER blocks for every column of the cluster table
# with them at once (:func:`_route_by_columns`; 7 clusters of 16 on an H100,
# so up to 7 columns); float64 rows keep the L2 body. Measured on an NVIDIA
# H100 80GB HBM3 at 700 W (chip_smoke.py --huge-split route; PERF.md section
# 6), warm ms forward + backward, the L2 body at the plan's G against the
# cluster body at the plan's C: float32 over 1, 5 and 7 columns (C = 16)
# 16,384 slots 0.52 / 0.56 / 0.56 against 0.42 / 0.46 / 0.48, 29,016 slots
# 0.52 / 0.60 / 0.61 against 0.47 / 0.55 / 0.56; over 8 and 16 columns (C =
# 8, 4) 16,384 slots 0.57 / 0.63 against 0.53 / 0.60, 29,016 slots 0.62 /
# 0.74 against 0.68 / 0.84; float64 16,384 and 19,316 slots over 1 to 16
# columns 0.58-0.76 against 0.57-0.92, the cluster body behind on 9 of 10
# (its forward's compare-and-swap into peers); mknap.t25.dual's 5 rows of
# 16,384 float32 slots 926-931 dual iterations a second against the L2
# body's 793-796.
BLOCK_ROWS_CLUSTER = {4: 16}


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``: the card's own count, SM_COUNT
    off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return SM_COUNT
    return torch.cuda.get_device_properties(device).multi_processor_count


def huge_smem_bytes(P: int, itemsize: int, two_rows: bool = False, ring: int = 0) -> int:
    """Dynamic shared memory of one block of the shared-memory huge body: one
    row of P values (keys, forward; cft, backward), a second with
    ``two_rows``, the slot codes (four bytes a slot), 64 values of partials
    and a ring of two slots of HUGE_SCALARS values. With ``ring`` (S hops,
    the ring form; ``two_rows`` for the backward and the run): the rows, 64
    values of partials and S + 1 stages of a hop's arc record (4P bytes),
    frontier row (P values) and HUGE_SCALARS values. ``uniform_sweep.cu``
    lays it out the same way (``RingLayout`` for the ring form)."""
    row = _pad_to(P * itemsize, 16)
    rows = row * (2 if two_rows else 1)
    if ring:
        stage = _pad_to(4 * P, 16) + row + HUGE_SCALARS * itemsize
        return rows + 64 * itemsize + (ring + 1) * stage
    return rows + _pad_to(4 * P, 16) + 64 * itemsize + 2 * HUGE_SCALARS * itemsize


def huge_fits(P: int, itemsize: int) -> bool:
    """Whether a bucket of width P takes the shared-memory huge body: its
    smallest block (one row) fits the shared memory a block
    may opt into, and its slots fit a slot code: in float32 up to 29,016
    slots, in float64 up to 19,316."""
    return P < HUGE_MAX_CODE and huge_smem_bytes(P, itemsize) <= MAX_DYNAMIC_SMEM


def cluster_code_bytes(pmax: int) -> int:
    """Bytes of a slot code of the cluster body in a launch whose widest
    bucket is ``pmax``: four (two 16-bit children) below CLUSTER_MAX_P, else
    eight (two 32-bit children). ``uniform_sweep.cu`` picks the same."""
    return 4 if pmax <= CLUSTER_MAX_P else 8


def cluster_smem_bytes(P: int, C: int, itemsize: int, two_rows: bool = False,
                       pmax: Optional[int] = None) -> int:
    """Dynamic shared memory of one block of the cluster body, C blocks a
    column: one row of its share of S = ceil(P / C) slots (keys, forward;
    cft, backward), a second with ``two_rows``, their slot codes (of the
    launch's widest bucket ``pmax``, P where not given:
    :func:`cluster_code_bytes`), 64 values of partials, the cluster's pairs
    of min-marginals (two values a block, for the largest cluster) and a ring
    of two slots of HUGE_SCALARS values. ``uniform_sweep.cu`` lays it out the
    same way."""
    S = -(-P // C)
    row = _pad_to(S * itemsize, 16)
    code = cluster_code_bytes(P if pmax is None else pmax)
    return (row * (2 if two_rows else 1) + _pad_to(code * S, 16)
            + (64 + 2 * max(CLUSTER_SIZES) + 2 * HUGE_SCALARS) * itemsize)


def cluster_fits(P: int, itemsize: int, C: int = max(CLUSTER_SIZES)) -> bool:
    """Whether the cluster body holds a bucket of width P in clusters of up
    to C blocks: a block's share at C, with its slot codes, fits the shared
    memory a block may opt into (at C = 16 up to 309,312 slots in float32
    and 231,552 in float64; at C = 8 154,656 and 115,776)."""
    return cluster_smem_bytes(P, C, itemsize) <= MAX_DYNAMIC_SMEM


def _card_occupancy(itemsize: int, body: str, threads: int, smem: int, own: Tuple[int, int],
                    counting: bool, device) -> int:
    """The card's answer of the library's occupancy entry for ``body`` (a
    suffix of :data:`SUFFIXES`) at ``threads`` threads and ``smem`` bytes of
    dynamic shared memory a block, ``own`` the body's two integers as its
    record holds them (:class:`BodyLaunch`; here the form they choose: the
    huge body's ring hops, the cluster body's C and widest bucket): blocks
    an SM holds of the huge and the L2 body (``counting``: of their counting
    entries; the least over the three entries), clusters the card holds of
    the cluster body (uniform_sweep.cu, ``body_occupancy``)."""
    import ctypes

    from bdd_tpu_torch import _build

    out = ctypes.c_int(0)
    fn = getattr(_build.load(), f"uniform_occupancy_f{8 * itemsize}")
    with torch.cuda.device(device):
        rc = fn(SUFFIXES.index(body), threads, smem, own[0], own[1], int(counting),
                ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"the occupancy query failed (code {rc}) for the {body[1:]} body at "
                           f"{threads} threads and {smem} B a block ({own})")
    return out.value


def block_occupancy(itemsize: int, body: str, threads: int, device, smem: int = 0,
                    own: Tuple[int, int] = (0, 0), counting: bool = False) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of dynamic shared
    memory that an SM holds at once of the shared-memory huge body (``body``
    "_huge"; ``own`` its launch's own integers, whose hops choose the ring
    form at that depth, 0 the grouped body) or of the L2 body ("_huge_l2",
    no shared memory); ``counting``: of the body's counting entries. On the
    card its own answer
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, the least over the
    three entries; 0 where a block may not take ``smem``); off it an
    estimate by the kernels' register bound (64 a thread at HUGE_THREADS):
    HUGE_THREADS // threads."""
    if torch.device(device).type == "cuda":
        return _card_occupancy(itemsize, body, threads, smem, own, counting, device)
    return max(1, HUGE_THREADS // threads)


def choose_l2_split(columns: int, pmax: int, threads: int, resident: int) -> int:
    """G, the blocks a column of the L2 body, for ``columns`` columns (of
    buckets with a hop) whose widest bucket is ``pmax`` slots, at
    ``threads`` threads a block on a card that holds ``resident`` such
    blocks at once: as many as the card holds for every column together, at
    most one a thread's worth of slots (ceil(pmax / threads)) and
    L2_MAX_SPLIT, at least 1. 66 for 2 columns on 132 SMs at one block an
    SM; 1 from 132 columns on (where the body runs as a block a column)."""
    if columns < 1:
        return 1
    return max(1, min(resident // columns, -(-pmax // threads), L2_MAX_SPLIT))


def l2_slots(P: int, G: int, g: int, threads: int) -> np.ndarray:
    """The slots block g of a column of G blocks of ``threads`` threads
    walks in a bucket of P slots, as the kernel's loops do (thread t = 32 w +
    lane takes first = (w G + g) L2_CHUNK + lane, then every stride = (threads
    / 32) G L2_CHUNK slots): the chunks of L2_CHUNK slots whose index is g
    modulo G, one slot a lane."""
    warps = threads // 32
    first = ((np.arange(warps)[:, None] * G + g) * L2_CHUNK + np.arange(32)[None, :]).reshape(-1)
    stride = warps * G * L2_CHUNK
    slots = first[None, :] + stride * np.arange(-(-P // stride) + 1)[:, None]
    return slots[slots < P]


def l2_scratch_bytes(values: int, split: int, columns: int, itemsize: int) -> Tuple[int, int, int]:
    """(byte offset of the partials, of the counters, bytes in all) of the L2
    body's scratch: the forward's key rows (``values`` values), then, where
    the split G is above 1, the partials of every column (G pairs of values)
    and its counter (four bytes); each part starts 16-byte aligned.
    ``uniform_sweep.cu`` reads them at these offsets."""
    rows = _pad_to(values * itemsize, 16)
    if split == 1:
        return rows, rows, rows
    counters = rows + _pad_to(2 * split * columns * itemsize, 16)
    return rows, counters, counters + 4 * columns


# The sweep bodies in launch order, by the names the route gives them; a
# body's suffix names its entries' keys of ``sweep_kernels.LAUNCHES``, and
# its index the body in the library's records (uniform_sweep.cu, Body).
BODIES = ("narrow", "wide", "huge", "huge_cluster", "huge_l2")
SUFFIXES = tuple("" if b == "narrow" else "_" + b for b in BODIES)


def body_of(P: int, itemsize: int, columns: int = 0, sms: int = SM_COUNT) -> str:
    """The body of a bucket of width P over ``columns`` columns by its width,
    in a solve of values of ``itemsize`` bytes on a card of ``sms`` SMs:
    "narrow", "wide", "huge" (the shared-memory form; also the wide buckets
    the route sends there: from HUGE_FROM slots on, in float32 below
    HUGE_FROM_F32_MANY only while the columns are at most HUGE_F32_BLOCKS_SM
    an SM), "huge_cluster" (rows that do not fit a block's shared memory,
    :func:`huge_fits`, but a cluster's of up to CLUSTER_ROUTED blocks:
    :func:`cluster_fits`) or "huge_l2" (the rest: past 309,312 slots in
    float32 and 115,776 in float64). The first step of :func:`route`, which
    holds the rest of the route on the tables as a whole."""
    if P <= NARROW_P:
        return "narrow"
    if P <= WIDE_P and not (P >= HUGE_FROM and (itemsize != 4 or P >= HUGE_FROM_F32_MANY
                                                or columns <= HUGE_F32_BLOCKS_SM * sms)):
        return "wide"
    if huge_fits(P, itemsize):
        return "huge"
    if cluster_fits(P, itemsize, CLUSTER_ROUTED[itemsize]):
        return "huge_cluster"
    return "huge_l2"


def lane_pad(nr_columns: int, P: int, lanes: int = 128) -> int:
    """Columns a bucket of ``nr_columns`` BDDs of width P is padded to: a
    multiple of ``lanes`` from ``lanes`` columns on (the JAX package's TPU
    lanes, kept so that both packages build the same layouts), else of 8. A
    huge bucket (P > WIDE_P) is not padded: its body runs a block a column,
    so a padding column costs a whole block's sweep and buys nothing (and
    132 columns stay one block an SM). ``csrc/bdd_host.cpp`` pads the same
    way."""
    if P > WIDE_P:
        return nr_columns
    return _pad_to(nr_columns, lanes if nr_columns >= lanes else 8)


@dataclasses.dataclass(frozen=True, eq=False)
class BodyLaunch:
    """One launch of a sweep body over its table of buckets: what the
    library's record of it holds (uniform_sweep.cu, ``Launch``) beside the
    L2 scratch. ``own``, the body's two integers: narrow (tile, widest
    bucket), wide (warps a block, shared memory a warp), huge (widest
    bucket, the ring form's hops or 0 for the grouped body), cluster (C, the
    blocks of a cluster, one column; widest bucket), L2 (G, the blocks a
    column; columns). The table's last column: the narrow and the wide
    body's hops in flight, the huge and the cluster body's rows the backward
    keeps in shared memory (1 or 2), the L2 body's offset (in values) into
    the forward's key rows ([B, 2, P] per bucket; 0 in the run's, which
    reads none); its ``first_block`` counts blocks, as many a column as the
    body takes (the narrow body a tile of columns a block, the wide body a
    warp a column)."""

    body: str  # one of SUFFIXES
    table: torch.Tensor  # int64 [nr_buckets, TABLE_COLUMNS] on the plan's device
    nr_buckets: int
    blocks: int
    threads: int  # a block
    smem_forward: int  # dynamic shared memory a block of the forward launch
    smem_backward: int  # the same, of the backward and the run
    own: Tuple[int, int]


@dataclasses.dataclass(frozen=True, eq=False)
class LaunchPlan:
    """What the launches of the sweep kernels over a list of buckets need
    beside the buffers: one launch per body (:data:`BODIES`, in that order)
    over the buckets :func:`route` gives it, each over its own table; the
    tables index the same flat buffers. ``sweeps`` are the half-sweeps'
    launches and ``runs`` the run-only entry's (its own route: the L2 body
    for the cluster body's buckets), each body's where it has blocks. The
    plan is cached and shared by every layout of its shapes, so it holds no
    buffer: each layout allocates its own L2 scratch (:func:`huge_scratch`:
    the key rows, and the partials and counters of the column barriers) of
    ``scratch_bytes``."""

    shapes: Tuple[Tuple[int, int, int], ...]  # (P, H, B) per bucket, every body
    arc_offsets: Tuple[int, ...]  # bytes into the records, per bucket
    E: int  # sum H * B
    N: int  # sum H * P * B
    arc_bytes: int
    sweeps: Tuple[BodyLaunch, ...]
    runs: Tuple[BodyLaunch, ...]
    # the L2 scratch (:func:`l2_scratch_bytes` of both entries' L2 launches,
    # which take turns on the layout's stream): byte offset of the partials,
    # of the counters, bytes in all
    scratch_bytes: Tuple[int, int, int]

    def launch(self, body: str, run: bool = False) -> Optional[BodyLaunch]:
        """The launch of ``body`` (a name of :data:`BODIES`) of the
        half-sweeps (``run``: of the run-only entry); None where it has no
        block."""
        suffix = SUFFIXES[BODIES.index(body)]
        return next((r for r in (self.runs if run else self.sweeps) if r.body == suffix), None)


def cell_bytes(P: int, itemsize: int) -> int:
    """Shared memory of one column of a narrow bucket in one ring slot: the
    record, padding up to a value, LAYER_ROWS + P values; rounded to its
    alignment and then to an odd count of 4- or 8-byte units (distinct banks
    across a warp). The kernel computes the same number (``Cell<T, P>::W``)."""
    G = record_bytes(P)
    values = -(-G // itemsize) * itemsize
    align = 16 if G >= 16 else (8 if G == 8 or itemsize == 8 else 4)
    raw = -(-(values + (LAYER_ROWS + P) * itemsize) // align) * align
    return raw + align if align < 16 and (raw // align) % 2 == 0 else raw


def slot_bytes(P: int, itemsize: int, tile: int) -> int:
    """Shared memory of one ring slot (one hop of a tile) of a narrow bucket."""
    return tile * cell_bytes(P, itemsize)


def wide_row_bytes(P: int, itemsize: int) -> int:
    """One frontier row of a wide bucket in shared memory (16-byte padded)."""
    return _pad_to(P * itemsize, 16)


def wide_slot_bytes(P: int, itemsize: int) -> int:
    """One ring slot of the wide kernel: the arc record of a hop and column,
    the incoming frontier row, WIDE_SCALARS layer values."""
    return _pad_to(4 * P, 16) + wide_row_bytes(P, itemsize) + WIDE_SCALARS * itemsize


def wide_warp_bytes(P: int, itemsize: int, stages: int) -> int:
    """Shared memory of one column (one warp) of the wide kernel: the frontier
    row and the row being built, and a ring of ``stages`` + 1 slots.
    ``uniform_sweep.cu`` computes the same sizes."""
    return 2 * wide_row_bytes(P, itemsize) + (stages + 1) * wide_slot_bytes(P, itemsize)


def _wide_plan(shapes, itemsize: int, stages: Optional[int], warps: Optional[int], sms: int):
    """(warps a block, stages, bytes a warp) of the wide launch over buckets
    ``shapes``. A warp copies WIDE_STAGES hops ahead (measured on the card: a
    deeper ring buys nothing at any column count, a ring of none costs a
    tenth). Few columns: few warps a block, so that the columns spread over
    the SMs; many: WIDE_WARPS a block, as many as the widest bucket lets fit.
    ``stages`` / ``warps`` force either (timing variants); a width whose
    single warp fits no block even without a ring raises ValueError."""
    widest = max(P for P, _, _ in shapes)
    if wide_warp_bytes(widest, itemsize, 0) > MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"a bucket of {widest} slots needs {wide_warp_bytes(widest, itemsize, 0)} bytes of "
            f"shared memory a warp; a block has {MAX_DYNAMIC_SMEM}")
    if stages is None:
        stages = WIDE_STAGES
    while wide_warp_bytes(widest, itemsize, stages) > MAX_DYNAMIC_SMEM:
        stages -= 1
    warp_bytes = wide_warp_bytes(widest, itemsize, stages)
    cols = sum(B for _, H, B in shapes if H > 0)
    if warps is None:
        warps = -(-cols // sms)
    warps = max(1, min(warps, WIDE_WARPS, MAX_DYNAMIC_SMEM // warp_bytes))
    return warps, stages, warp_bytes


def _offsets(shapes):
    rows, nodes, arcs = [], [], []
    e = n = a = 0
    for P, H, B in shapes:
        rows.append(e)
        nodes.append(n)
        arcs.append(a)
        e += H * B
        n += H * P * B
        a = _pad_to(a + H * B * record_bytes(P), ARC_ALIGN)
    return tuple(rows), tuple(nodes), tuple(arcs), e, n, a


def _huge_plan(shapes, itemsize: int, sms: int, ring: Optional[int] = None):
    """(threads a block, the backward's rows per bucket, shared memory of a
    forward and of a backward block, the ring form's hops or 0) of the
    shared-memory huge launch over ``shapes``. An SM holds as many of its
    blocks as the columns ask for and the grouped body's shared memory (its
    widest bucket's) lets reside; they share the SM's 1,024 threads of 64
    registers. The backward keeps two rows where that many blocks still fit
    with them. The forward gathers cft of hop h+1 through L1 (staged in
    shared memory one hop ahead at 4 to 16 slots a thread it was slower:
    chip_smoke.py --huge-split; PERF.md section 6). Where no bucket is wider
    than the threads (one slot a thread, where the hop waits on its loads)
    the launch takes the ring form instead, HUGE_RING_HOPS hops ahead
    (``ring``: that many, or False / 0 for the grouped body), and its shared
    memory; at most 1,024 slots a block, the stages of every depth up to
    HUGE_RING_MAX leave the same blocks room to reside."""
    cols = sum(B for _, H, B in shapes if H > 0)
    fwd = max(huge_smem_bytes(P, itemsize) for P, _, _ in shapes)
    resident = max(1, min(-(-cols // sms), SM_SMEM // (fwd + BLOCK_SMEM_RESERVED)))
    threads = max(32, HUGE_THREADS // resident // 32 * 32)

    def two_rows(P: int) -> bool:
        nbytes = huge_smem_bytes(P, itemsize, two_rows=True)
        return (nbytes <= MAX_DYNAMIC_SMEM
                and resident * (nbytes + BLOCK_SMEM_RESERVED) <= SM_SMEM)

    rows = [2 if two_rows(P) else 1 for P, _, _ in shapes]
    hops = HUGE_RING_HOPS if ring is None else int(ring)
    if not 0 <= hops <= HUGE_RING_MAX:
        raise ValueError(f"the huge body's ring takes 0 to {HUGE_RING_MAX} hops, not {ring}")
    pmax = max(P for P, _, _ in shapes)
    if hops and pmax <= threads:
        return (threads, rows, huge_smem_bytes(pmax, itemsize, ring=hops),
                huge_smem_bytes(pmax, itemsize, two_rows=True, ring=hops), hops)
    bwd = max(huge_smem_bytes(P, itemsize, two_rows=r == 2) for (P, _, _), r in zip(shapes, rows))
    return threads, rows, fwd, bwd, 0


def _route_huge_table(shapes, body, itemsize: int, sms: int):
    """``body`` (per bucket, :func:`body_of`) with the route's float32 rule
    held on the huge table as a whole. One launch runs the table at one
    thread count and one block's shared memory, its widest bucket's
    (:func:`_huge_plan`), so a float32 bucket below HUGE_FROM_F32_MANY that
    the route sent there by its own columns goes back to the wide body where
    the table's columns are more than HUGE_F32_BLOCKS_SM an SM (its blocks
    would get 128 threads or fewer), or more an SM than that shared memory
    lets reside (they would wait, a wave at a time, behind the widest
    bucket's blocks)."""
    few = [k for k, b in enumerate(body)
           if b == "huge" and itemsize == 4 and shapes[k][0] < HUGE_FROM_F32_MANY]
    if not few:
        return body
    huge = [shapes[k] for k, b in enumerate(body) if b == "huge"]
    per_sm = -(-sum(B for _, H, B in huge if H > 0) // sms)
    fwd = max(huge_smem_bytes(P, itemsize) for P, _, _ in huge)
    if per_sm <= min(HUGE_F32_BLOCKS_SM, SM_SMEM // (fwd + BLOCK_SMEM_RESERVED)):
        return body
    return ["wide" if k in few else b for k, b in enumerate(body)]


def _columns(shapes, body, which: str) -> int:
    """Columns (of buckets with a hop) of the buckets that ``body`` gives
    ``which``."""
    return sum(B for (_, H, B), b in zip(shapes, body) if b == which and H > 0)


def _route_by_columns(shapes, body, resident: int, clusters: int = 0):
    """``body`` (per bucket, :func:`body_of`) with the rule by columns held
    on the L2 table as a whole. One launch runs that table at one G, the
    card's ``resident`` blocks over all its columns (:func:`choose_l2_split`),
    so a bucket past WIDE_P that a cluster or a block holds (the cluster or
    the shared-memory huge body by its width) joins it only where G, counted
    with the bucket and every one that joined before, stays at least
    L2_FROM_SPLIT. They try in a fixed order, widest first (then in table
    order), so the table's G at the end is the last joiner's, at or above
    L2_FROM_SPLIT. A bucket that a block holds and that would join takes the
    cluster body instead while the card's ``clusters`` clusters of the
    route's largest size (BLOCK_ROWS_CLUSTER; 0: none) hold every column of
    the cluster table with it at once; the wider buckets that a cluster holds
    have chosen before it. Buckets at or below WIDE_P keep their body: the
    L2 body reads only four-byte records."""
    held = [k for k, b in enumerate(body)
            if b == "huge_cluster" or b == "huge" and shapes[k][0] > WIDE_P]
    if not held:
        return body
    body = list(body)
    cols = _columns(shapes, body, "huge_l2")
    pmax = max((P for (P, _, _), b in zip(shapes, body) if b == "huge_l2"), default=0)
    for k in sorted(held, key=lambda k: (-shapes[k][0], k)):
        P, H, B = shapes[k]
        own = B if H > 0 else 0
        if choose_l2_split(cols + own, max(pmax, P), HUGE_THREADS, resident) < L2_FROM_SPLIT:
            continue
        if body[k] == "huge" and own + _columns(shapes, body, "huge_cluster") <= clusters:
            body[k] = "huge_cluster"
        else:
            body[k] = "huge_l2"
            cols, pmax = cols + own, max(pmax, P)
    return body


def cluster_occupancy(itemsize: int, C: int, threads: int, smem: int, device, sms: int,
                      pmax: int) -> int:
    """Clusters of C blocks of ``threads`` threads and ``smem`` bytes of
    shared memory that the card holds at once, for a table whose widest
    bucket is ``pmax`` (its slot code picks the kernel): on the card its own
    answer (``cudaOccupancyMaxActiveClusters`` of the forward kernel). Off
    it, an estimate: the blocks an SM holds by shared memory and threads, in
    whole clusters within each GPC of GPC_SMS (a card of ``sms`` SMs other
    than their sum counts as one GPC). Over the SMs alone the estimate would
    over-count large clusters: at one block an SM 132 // 16 = 8 clusters of
    16, where the card holds 7. With several blocks an SM the card's answer
    is lower than the estimate (58 clusters of 16 at 13 blocks an SM against
    104; PERF.md section 6), so the estimate is an upper bound there."""
    if torch.device(device).type == "cuda":
        return _card_occupancy(itemsize, "_huge_cluster", threads, smem, (C, pmax), False, device)
    per_sm = min(SM_SMEM // (smem + BLOCK_SMEM_RESERVED), HUGE_THREADS // threads)
    gpcs = GPC_SMS if sms == sum(GPC_SMS) else (sms,)
    return sum(n * per_sm // C for n in gpcs)


def _cluster_plan(shapes, itemsize: int, sms: int, device: str, size: Optional[int]):
    """(C, threads a block, the backward's rows per bucket, shared memory of
    a forward and of a backward block) of the cluster launch over
    ``shapes``. For each cluster size C of CLUSTER_SIZES (``size`` forces
    one) whose block share of the widest bucket fits a block: as many blocks
    an SM as the columns' C blocks ask for and the forward's shared memory
    lets reside, sharing the SM's 1,024 threads; the card's answer for the
    clusters it holds at once (:func:`cluster_occupancy`). The plan takes
    the C of the fewest waves of clusters times slots a thread (the passes a
    hop makes), the smallest C on a tie (fewest barriers and remote
    accesses). The slot codes are the widest bucket's
    (:func:`cluster_code_bytes`). The backward keeps two rows where that many
    blocks still fit with them. A width no C holds raises ValueError."""
    cols = max(1, sum(B for _, H, B in shapes if H > 0))
    widest = max(P for P, _, _ in shapes)
    best = None
    for C in ((size,) if size else CLUSTER_SIZES):
        fwd = cluster_smem_bytes(widest, C, itemsize)
        if fwd > MAX_DYNAMIC_SMEM:
            continue
        resident = max(1, min(-(-cols * C // sms), SM_SMEM // (fwd + BLOCK_SMEM_RESERVED)))
        threads = max(32, HUGE_THREADS // resident // 32 * 32)
        active = cluster_occupancy(itemsize, C, threads, fwd, device, sms, widest)
        if active < 1:
            continue
        share = -(-widest // C)
        cost = -(-cols // active) * -(-share // threads)
        if best is None or cost < best[0]:
            best = (cost, C, threads, resident, fwd)
    if best is None:
        raise ValueError(f"no cluster of {CLUSTER_SIZES if not size else size} blocks holds a "
                         f"bucket of {widest} slots")
    _, C, threads, resident, fwd = best

    def two_rows(P: int) -> bool:
        nbytes = cluster_smem_bytes(P, C, itemsize, two_rows=True, pmax=widest)
        return (nbytes <= MAX_DYNAMIC_SMEM
                and resident * (nbytes + BLOCK_SMEM_RESERVED) <= SM_SMEM)

    rows = [2 if two_rows(P) else 1 for P, _, _ in shapes]
    bwd = max(cluster_smem_bytes(P, C, itemsize, two_rows=r == 2, pmax=widest)
              for (P, _, _), r in zip(shapes, rows))
    return C, threads, rows, fwd, bwd


def route(shapes, itemsize: int, device) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The bodies (names of :data:`BODIES`) of the half-sweeps and of the
    run-only entry, per bucket of ``shapes``, in a solve of values of
    ``itemsize`` bytes on ``device``: the one place that decides which body
    takes a bucket. Each bucket first takes the body of its width
    (:func:`body_of`); then the rule by columns holds on the L2 table as a
    whole (:func:`_route_by_columns`; float32 rows a block holds over few
    columns take the cluster body) and the float32 rule on the huge table
    that it leaves (:func:`_route_huge_table`). The run-only entry takes the
    L2 body for the cluster body's buckets (it led on every layout measured,
    L2_FROM_SPLIT) and the half-sweeps' body for the others."""
    sms = sm_count(device)
    body = [body_of(P, itemsize, B, sms) for P, _, B in shapes]
    if any(b in ("huge_cluster", "huge_l2") or b == "huge" and P > WIDE_P
           for b, (P, _, _) in zip(body, shapes)):
        # the L2 body's blocks the card holds at once, and the clusters of
        # BLOCK_ROWS_CLUSTER blocks over the rows a block holds past WIDE_P,
        # where the precision has any
        resident = sms * block_occupancy(itemsize, "_huge_l2", HUGE_THREADS, device)
        C = BLOCK_ROWS_CLUSTER.get(itemsize)
        block = [P for (P, _, _), b in zip(shapes, body) if b == "huge" and P > WIDE_P]
        clusters = 0
        if C and block:
            clusters = cluster_occupancy(itemsize, C, HUGE_THREADS,
                                         cluster_smem_bytes(max(block), C, itemsize), device,
                                         sms, max(block))
        body = _route_by_columns(shapes, body, resident, clusters)
    body = _route_huge_table(shapes, body, itemsize, sms)
    return tuple(body), tuple("huge_l2" if b == "huge_cluster" else b for b in body)


def _table(shapes, members, offsets, times: int, per: int, last, device):
    """(table on ``device``, blocks) of the buckets ``members`` (indices into
    ``shapes``): per bucket P, H, B, its first block, its offsets into the
    buffers (``offsets``: :func:`_offsets`) and ``last[r]``; a bucket with a
    hop takes ceil(B * times / per) blocks."""
    rows, nodes, arcs = offsets[:3]
    table = np.zeros((len(members), TABLE_COLUMNS), dtype=np.int64)
    block = 0
    for r, k in enumerate(members):
        P, H, B = shapes[k]
        table[r] = (P, H, B, block, rows[k], nodes[k], arcs[k], last[r])
        block += -(-B * times // per) if H > 0 else 0
    return torch.from_numpy(table).to(device), block


def _body_launch(body: str, shapes, members, itemsize: int, device: str, offsets,
                 key_rows: bool, tune: dict) -> Optional[BodyLaunch]:
    """The launch of ``body`` over the buckets ``members`` (indices into
    ``shapes``), None where it has no block; ``key_rows``: the L2 table's
    last column the buckets' offsets into the key rows (the half-sweeps'),
    else 0; ``tune``: :func:`build_plan`'s keywords."""
    mine = [shapes[k] for k in members]
    if not mine:
        return None
    pmax = max(P for P, _, _ in mine)
    sms = sm_count(device)
    if body == "narrow":  # a tile of columns a block, one thread each
        cols = sum(B for _, _, B in mine)
        tile = TILE_SMALL if cols <= TILE_SWITCH else TILE_LARGE
        want = tune["stages"] or min(MAX_STAGES,
                                     max(MIN_STAGES, -(-STAGE_COLUMNS // max(cols, 1))))
        last = [max(1, min(want, SMEM_BUDGET // slot_bytes(P, itemsize, tile) - 1))
                for P, _, _ in mine]  # S + 1 slots in the ring
        fwd = bwd = max((S + 1) * slot_bytes(P, itemsize, tile)
                        for (P, _, _), S in zip(mine, last))
        times, per, threads, own = 1, tile, tile, (tile, pmax)
    elif body == "wide":  # a warp a column
        warps, depth, warp_bytes = _wide_plan(mine, itemsize, tune["wide_stages"],
                                              tune["wide_warps"], sms)
        last, threads, own = [depth] * len(mine), 32 * warps, (warps, warp_bytes)
        fwd = bwd = warps * warp_bytes
        times, per = 1, warps
    elif body == "huge":  # a block a column
        threads, last, fwd, bwd, hops = _huge_plan(mine, itemsize, sms, tune["ring_hops"])
        times, per, own = 1, 1, (pmax, hops)
    elif body == "huge_cluster":  # a cluster of C blocks a column
        C, threads, last, fwd, bwd = _cluster_plan(mine, itemsize, sms, device,
                                                   tune["cluster_size"])
        times, per, own = C, 1, (C, pmax)
    else:  # the L2 body: G blocks a column
        cols = sum(B for _, H, B in mine if H > 0)
        split = tune["l2_split"] or (choose_l2_split(
            cols, pmax, HUGE_THREADS,
            sms * block_occupancy(itemsize, "_huge_l2", HUGE_THREADS, device)) if cols else 1)
        last = list(np.cumsum([0] + [2 * P * B for P, _, B in mine])[:-1]) if key_rows else (
            [0] * len(mine))
        threads, fwd, bwd, own = HUGE_THREADS, 0, 0, (split, cols)
        times, per = split, 1
    table, blocks = _table(shapes, members, offsets, times, per, last, device)
    if not blocks:
        return None
    return BodyLaunch(SUFFIXES[BODIES.index(body)], table, len(mine), blocks, threads, fwd, bwd,
                      own)


def _plan(shapes, itemsize: int, device: str, bodies, run_bodies, tune: dict) -> LaunchPlan:
    if len(bodies) != len(shapes) or len(run_bodies) != len(shapes) or not set(
            bodies + run_bodies) <= set(BODIES):
        raise ValueError(f"a body of {BODIES} per bucket, for {len(shapes)} buckets: "
                         f"{bodies} / {run_bodies}")
    if tune["l2_split"] is not None and not 1 <= tune["l2_split"] <= L2_MAX_SPLIT:
        raise ValueError(f"the L2 body takes 1 to {L2_MAX_SPLIT} blocks a column, "
                         f"not {tune['l2_split']}")
    offsets = _offsets(shapes)
    sweeps, runs = [], []
    for body in BODIES:
        members = [k for k, b in enumerate(bodies) if b == body]
        run_members = [k for k, b in enumerate(run_bodies) if b == body]
        launch = _body_launch(body, shapes, members, itemsize, device, offsets, True, tune)
        if run_members != members or body == "huge_l2":  # the run reads no key rows
            run = _body_launch(body, shapes, run_members, itemsize, device, offsets, False, tune)
        else:
            run = launch
        sweeps += [launch] if launch else []
        runs += [run] if run else []
    # the L2 scratch: the half-sweeps' key rows, then room for the partials
    # and the counters of whichever L2 launch needs more
    values = sum(2 * shapes[k][0] * shapes[k][2] for k, b in enumerate(bodies) if b == "huge_l2")
    half, run = (l2_scratch_bytes(values, *next((r.own for r in launches if r.body == "_huge_l2"),
                                                (1, 0)), itemsize)
                 for launches in (sweeps, runs))
    counters = max(half[1], run[1])
    return LaunchPlan(shapes=shapes, arc_offsets=offsets[2], E=offsets[3], N=offsets[4],
                      arc_bytes=offsets[5], sweeps=tuple(sweeps), runs=tuple(runs),
                      scratch_bytes=(half[0], counters,
                                     counters + max(half[2] - half[1], run[2] - run[1])))


_TUNABLES = dict(stages=None, wide_stages=None, wide_warps=None, cluster_size=None,
                 l2_split=None, ring_hops=None)


def _shapes(shapes) -> Tuple[Tuple[int, int, int], ...]:
    return tuple(tuple(int(x) for x in s) for s in shapes)


@functools.lru_cache(maxsize=256)
def _launch_plan(shapes, itemsize: int, device: str) -> LaunchPlan:
    return _plan(shapes, itemsize, device, *route(shapes, itemsize, device), _TUNABLES)


def launch_plan(shapes, dtype: torch.dtype, device) -> LaunchPlan:
    """The plan of one launch per body over buckets of ``shapes`` ((P, H, B)
    each) whose buffers lie flat, bucket after bucket, each bucket on the
    body :func:`route` gives it. Built once per distinct argument list
    (cached)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _launch_plan(_shapes(shapes), itemsize, str(torch.device(device)))


def build_plan(shapes, dtype: torch.dtype, device, bodies: Sequence[str],
               run_bodies: Optional[Sequence[str]] = None, *, stages: Optional[int] = None,
               wide_stages: Optional[int] = None, wide_warps: Optional[int] = None,
               cluster_size: Optional[int] = None, l2_split: Optional[int] = None,
               ring_hops: Optional[int] = None) -> LaunchPlan:
    """The plan of ``shapes`` as :func:`launch_plan` builds it, but on the
    bodies given, for timing and tests: ``bodies`` (names of :data:`BODIES`)
    per bucket for the half-sweeps, ``run_bodies`` for the run-only entry
    (default ``bodies``). The keywords reach the kernel paths the route's
    plan does not choose: ``stages`` the prefetch depth of the narrow
    buckets, ``wide_stages`` and ``wide_warps`` the depth and the warps a
    block of the wide ones, ``cluster_size`` the blocks of the cluster
    body's clusters (2, 4, 8 or 16), ``l2_split`` the blocks a column of the
    L2 body (1 to L2_MAX_SPLIT; more than the card holds at once is refused
    at the launch), ``ring_hops`` the hops of the shared-memory huge body's
    ring form where it takes that form (1 to HUGE_RING_MAX; 0: the grouped
    body on the same table). Not cached."""
    bodies = tuple(bodies)
    tune = dict(stages=stages, wide_stages=wide_stages, wide_warps=wide_warps,
                cluster_size=cluster_size, l2_split=l2_split, ring_hops=ring_hops)
    return _plan(_shapes(shapes), torch.empty((), dtype=dtype).element_size(),
                 str(torch.device(device)), bodies,
                 bodies if run_bodies is None else tuple(run_bodies), tune)


def huge_scratch(plan: LaunchPlan, device) -> Optional[torch.Tensor]:
    """The scratch of the L2 body over ``plan``'s buckets in its tables (uint8,
    ``plan.scratch_bytes``: the forward's key rows, and where a launch
    splits a column the partials and counters that it uses): one buffer per
    layout, made with it and freed with it. None off the card (the twins need
    none) and where the plan sends no bucket of any entry to the L2 body."""
    device = torch.device(device)
    if device.type != "cuda" or all(r.body != "_huge_l2" for r in plan.sweeps + plan.runs):
        return None
    return torch.empty(plan.scratch_bytes[2], dtype=torch.uint8, device=device)


def solve_bytes(shapes, itemsize: int) -> int:
    """Device memory a solve over buckets of ``shapes`` works in: the arc
    records, per layer the state, the half-sweep's outputs, the deltas, alpha
    and three int64 index entries, per node the frontier in and out, and the
    scratch of the L2 body as the most the route can give these buckets: the
    key rows of every bucket past WIDE_P (each may take the L2 body,
    :func:`_route_by_columns`; the other bodies keep none), and
    the partials and counters of all their columns (the run's L2 table takes
    them all) at L2_MAX_SPLIT blocks a column (a few KB a column at most
    above the plan's own)."""
    _, _, _, E, N, arcs = _offsets(shapes)
    l2 = [(P, H, B) for P, H, B in shapes if P > WIDE_P]
    columns = sum(B for _, H, B in l2 if H > 0)
    split = L2_MAX_SPLIT if columns else 1
    scratch = l2_scratch_bytes(sum(2 * P * B for P, _, B in l2), split, columns, itemsize)[2]
    return arcs + E * (9 * itemsize + 3 * 8) + 2 * N * itemsize + scratch


def _check_device_memory(shapes, itemsize: int, device: torch.device) -> None:
    """Raise MemoryError, naming the bytes, when a layout does not fit the
    card's free memory: the one limit on a bucket's width. Free is what the
    driver reports free plus what PyTorch's caching allocator holds reserved
    but unused (a warm process keeps freed tensors' memory there, and
    reuses it for the layout)."""
    if device.type != "cuda":
        return
    need = solve_bytes(shapes, itemsize)
    free, total = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    if need > free + cached:
        widest = max((P for P, _, _ in shapes), default=0)
        raise MemoryError(
            f"the layout (widest bucket P={widest}, {len(shapes)} buckets) needs {need} bytes "
            f"of device memory to solve; {device} has {free} of {total} free and {cached} "
            f"cached by the allocator")


@dataclasses.dataclass(frozen=True)
class UniformGeom:
    buckets: Tuple[BucketGeom, ...]
    num_bdds_per_var: torch.Tensor  # int64 [V]
    exchange: ExchangeIndex
    dtype: torch.dtype
    device: torch.device
    arcs: torch.Tensor  # uint8 [plan.arc_bytes]: every bucket's records
    alpha: torch.Tensor  # float [E]
    plan: LaunchPlan  # the launches over all buckets
    huge_scratch: Optional[torch.Tensor] = None  # the L2 body's scratch (:func:`huge_scratch`)

    @property
    def V(self) -> int:
        return self.num_bdds_per_var.shape[0]

    @property
    def sizes(self) -> Tuple[int, ...]:
        """H * B per bucket: the bucket blocks of the flat slot order."""
        return tuple(g.H * g.B for g in self.buckets)

    def per_bucket(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """[H, B] views of a flat [E] tensor, one per bucket."""
        return tuple(
            x.view(g.H, g.B) for g, x in zip(self.buckets, flat.split(self.sizes))
        )

    def per_bucket_nodes(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """[H, P, B] views of a flat [N] frontier tensor, one per bucket; a
        wide bucket's is the transposed view of its [H, B, P] storage."""
        sizes = [g.H * g.P * g.B for g in self.buckets]
        return tuple(
            x.view(g.H, g.P, g.B) if g.P <= NARROW_P else x.view(g.H, g.B, g.P).transpose(1, 2)
            for g, x in zip(self.buckets, flat.split(sizes))
        )

    def flatten_nodes(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-bucket [H, P, B] frontier tensors laid flat in the storage order
        of :meth:`per_bucket_nodes` (one concatenation)."""
        return flatten([
            x if g.P <= NARROW_P else x.transpose(1, 2) for g, x in zip(self.buckets, xs)
        ])


@dataclasses.dataclass(frozen=True)
class UniformState:
    """Costs, deferred marginals and costs-to-terminal: four flat tensors
    over all buckets (``flat``: lo, hi, def_mm [E] and cft [N]), which the
    iteration and the exchange read and write, and per-bucket views of them.
    Built by :func:`state_from_flat` or :func:`state_from_buckets`."""

    lo: Tuple[torch.Tensor, ...]  # per bucket [H, B]
    hi: Tuple[torch.Tensor, ...]
    def_mm: Tuple[torch.Tensor, ...]
    cft: Tuple[torch.Tensor, ...]  # per bucket [H, P, B]
    flat: Tuple[torch.Tensor, ...]


def state_from_flat(geom: UniformGeom, lo, hi, def_mm, cft) -> UniformState:
    """A state over flat tensors (lo, hi, def_mm [E]; cft [N])."""
    return UniformState(
        geom.per_bucket(lo), geom.per_bucket(hi), geom.per_bucket(def_mm),
        geom.per_bucket_nodes(cft), (lo, hi, def_mm, cft),
    )


def flatten(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-bucket tensors laid flat, bucket after bucket (one concatenation)."""
    return torch.cat([x.reshape(-1) for x in xs]) if xs else torch.zeros(0)


def state_from_buckets(geom: UniformGeom, lo, hi, def_mm, cft) -> UniformState:
    """A state from per-bucket tensors (one concatenation each)."""
    return state_from_flat(geom, flatten(lo), flatten(hi), flatten(def_mm),
                           geom.flatten_nodes(cft))


@dataclasses.dataclass(frozen=True)
class UniformHost:
    """Geometry plus host-side bookkeeping (numpy). With column packing,
    ``bdd_of_col``/``depths`` describe the FIRST segment of each column;
    ``layer_bdd`` is exact per slot."""

    geom: UniformGeom
    bdd_of_col: Tuple[np.ndarray, ...]  # per bucket [B] (-1 pad)
    depths: Tuple[np.ndarray, ...]  # per bucket [B]
    nr_vars: int
    nr_primal_vars: int
    nr_bdds: int
    layer_bdd: Tuple[np.ndarray, ...]  # per bucket [H, B] (-1 pad)


# ------------------------------------------------------------ numpy buckets
# Host building works on plain dicts of numpy arrays (keys: _NODE_KEYS,
# _LAYER_KEYS, root_mask, bdd_of_col, depths); alpha stays float64 until the
# final cast so f32 alphas round exactly as the JAX package's do.


def root_rows(layer_valid: np.ndarray, root_mask: Optional[np.ndarray]) -> np.ndarray:
    """[H, B] bool: rows where a BDD root (slot 0) sits (uniform.py:1140)."""
    if root_mask is not None:
        return np.asarray(root_mask, dtype=bool)
    rows = np.zeros(layer_valid.shape, dtype=bool)
    rows[:1] = layer_valid[:1]
    return rows


def _native_buckets(nh) -> Tuple[List[dict], np.ndarray]:
    """Bucket dicts and per-variable BDD counts from a ``NativeHost``
    (the numpy half of native.py:326-382)."""
    V = nh.nr_vars()
    raw = [nh.bucket_arrays(k) for k in range(nh.nr_buckets())]
    counts = np.zeros(V, dtype=np.int32)
    for a in raw:
        np.add.at(counts, a["layer_var"][a["layer_valid"]], 1)
    counts_safe = np.maximum(counts, 1)
    buckets = []
    for a in raw:
        m = a["layer_valid"]
        alpha = np.zeros(m.shape)
        alpha[m] = 1.0 / counts_safe[a["layer_var"][m]]
        lbdd = np.broadcast_to(a["bdd_of_col"][None, :], m.shape).copy()
        lbdd[~m] = -1
        buckets.append(dict(
            node_valid=a["node_valid"],
            lo_kind=a["lo_kind"].astype(np.int32),
            lo_slot=a["lo_slot"].astype(np.int32),
            hi_kind=a["hi_kind"].astype(np.int32),
            hi_slot=a["hi_slot"].astype(np.int32),
            layer_valid=m,
            layer_var=a["layer_var"].astype(np.int32),
            alpha=alpha,
            layer_bdd=lbdd,
            root_mask=None,
            bdd_of_col=a["bdd_of_col"],
            depths=a["depths"],
        ))
    return buckets, counts


def _ffd_pack(depths: np.ndarray, cap: int):
    """Worst-fit-decreasing column packing. Returns (column, row0) per
    segment (input order) and the number of columns (uniform.py:863)."""
    order = np.argsort(-depths, kind="stable")
    col = np.zeros(depths.size, dtype=np.int64)
    row0 = np.zeros(depths.size, dtype=np.int64)
    heap: List[Tuple[int, int]] = []  # (fill, column)
    ncols = 0
    for i in order:
        d = int(depths[i])
        if heap and heap[0][0] + d <= cap:
            fill, c = heapq.heappop(heap)
        else:
            fill, c = 0, ncols
            ncols += 1
        col[i] = c
        row0[i] = fill
        heapq.heappush(heap, (fill + d, c))
    return col, row0, ncols


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pack_candidates(max_d: int) -> List[int]:
    """Candidate packed-column heights: multiples of the deepest member."""
    if max_d > PACK_H_CAP:
        return [max_d]
    return sorted({min(m * max_d, max(PACK_H_CAP, max_d)) for m in (1, 2, 3, 4)})


def _pack_eval(deps: np.ndarray, cap: int, P: int):
    """FFD-pack ``deps`` (BDDs of width P) under ``cap``; returns (cost, col,
    row0, H, B) under the cost model bucket area + PACK_LAMBDA per serial
    row."""
    col, row0, nc = _ffd_pack(deps, cap)
    H = int((row0 + deps).max())
    B = lane_pad(nc, P)
    return H * B + PACK_LAMBDA * H, col, row0, H, B


def choose_pack_caps(depths_by_class: Dict[int, np.ndarray]) -> Dict[Tuple[int, int], int]:
    """The packed-column height per (width class P, depth tier) under the
    cost model of :func:`_pack_buckets`, from a pooled multiset of segment
    depths per class (uniform.py:908-937). The sharded solve pools the depths
    of all its shards and packs every shard with the result, so that the
    shards' buckets take the same heights."""
    caps: Dict[Tuple[int, int], int] = {}
    for P, deps_all in depths_by_class.items():
        deps_all = np.asarray(deps_all, dtype=np.int64)
        for ti, sel in enumerate((deps_all <= PACK_H_CAP, deps_all > PACK_H_CAP)):
            deps = deps_all[sel]
            if deps.size == 0:
                continue
            max_d = int(deps.max())
            if max_d > PACK_H_CAP:
                caps[(int(P), ti)] = max_d
                continue
            best = None
            for cap in _pack_candidates(max_d):
                cost = _pack_eval(deps, cap, int(P))[0]
                if best is None or cost < best[0]:
                    best = (cost, cap)
            caps[(int(P), ti)] = best[1]
    return caps


def _pack_buckets(buckets: Sequence[dict], nr_vars: int,
                  caps: Optional[Dict[Tuple[int, int], int]] = None) -> List[dict]:
    """Vertical column packing (uniform.py:939-1075): per width class P and
    depth tier (<= / > PACK_H_CAP), stack the BDDs of all buckets into the
    columns of one bucket, with ``root_mask`` marking segment starts. The
    column height per (P, tier) is ``caps``' (:func:`choose_pack_caps`), by
    default chosen from these buckets' own depths."""
    assert all(b["root_mask"] is None for b in buckets), "already packed"
    classes: Dict[int, List[Tuple[int, int, int, int]]] = {}
    for k, bk in enumerate(buckets):
        deps = bk["depths"]
        for c in np.nonzero(deps > 0)[0]:
            classes.setdefault(bk["node_valid"].shape[1], []).append(
                (int(deps[c]), k, int(c), int(bk["bdd_of_col"][c]))
            )
    if caps is None:
        caps = choose_pack_caps({P: [s[0] for s in segs] for P, segs in classes.items()})
    out: List[dict] = []
    for P in sorted(classes):
        segs = classes[P]
        tiers = [
            [s for s in segs if s[0] <= PACK_H_CAP],
            [s for s in segs if s[0] > PACK_H_CAP],
        ]
        for ti, tier in enumerate(tiers):
            if not tier:
                continue
            deps = np.array([s[0] for s in tier], dtype=np.int64)
            max_d = int(deps.max())
            _, col, row0, H, B = _pack_eval(deps, max(caps.get((P, ti), max_d), max_d), P)
            nb = dict(
                node_valid=np.zeros((H, P, B), dtype=bool),
                lo_kind=np.full((H, P, B), ARC_BOT, dtype=np.int32),
                lo_slot=np.zeros((H, P, B), dtype=np.int32),
                hi_kind=np.full((H, P, B), ARC_BOT, dtype=np.int32),
                hi_slot=np.zeros((H, P, B), dtype=np.int32),
                layer_valid=np.zeros((H, B), dtype=bool),
                layer_var=np.full((H, B), nr_vars, dtype=np.int32),
                alpha=np.zeros((H, B)),
                layer_bdd=np.full((H, B), -1, dtype=np.int64),
                root_mask=np.zeros((H, B), dtype=bool),
                bdd_of_col=np.full(B, -1, dtype=np.int64),
                depths=np.zeros(B, dtype=np.int32),
            )
            by_src: Dict[int, List[int]] = {}
            for i, (_, k, _, _) in enumerate(tier):
                by_src.setdefault(k, []).append(i)
            for k, idxs in by_src.items():
                d = deps[idxs]
                sc = np.array([tier[i][2] for i in idxs], dtype=np.int64)
                bdd = np.array([tier[i][3] for i in idxs], dtype=np.int64)
                dc = col[idxs]
                r0 = row0[idxs]
                h_idx = np.concatenate([np.arange(x) for x in d])
                src_c = np.repeat(sc, d)
                dst_r = np.concatenate([r + np.arange(x) for r, x in zip(r0, d)])
                dst_c = np.repeat(dc, d)
                src = buckets[k]
                for name in _NODE_KEYS:
                    nb[name][dst_r, :, dst_c] = src[name][h_idx, :, src_c]
                for name in _LAYER_KEYS:
                    nb[name][dst_r, dst_c] = src[name][h_idx, src_c]
                nb["root_mask"][r0, dc] = True
                first = r0 == 0
                nb["bdd_of_col"][dc[first]] = bdd[first]
                nb["depths"][dc[first]] = d[first]
            out.append(nb)
    return out


def check_lengths(lengths: np.ndarray, nr_slots: int) -> None:
    """The contract ``torch.segment_reduce`` would check on every call: no
    negative length, and the lengths cover exactly the gathered slots."""
    lengths = np.asarray(lengths)
    if lengths.size and lengths.min() < 0:
        raise ValueError("exchange index: negative segment length")
    if int(lengths.sum()) != nr_slots:
        raise ValueError(
            f"exchange index: segment lengths sum to {int(lengths.sum())}, "
            f"but {nr_slots} valid slots are gathered"
        )


def _exchange_index(buckets: Sequence[dict], V: int, device) -> ExchangeIndex:
    ids = np.concatenate([b["layer_var"].ravel() for b in buckets]).astype(np.int64)
    valid = np.concatenate([b["layer_valid"].ravel() for b in buckets]).astype(bool)
    ids = np.where(valid, ids, V)
    real = np.nonzero(valid)[0]
    order = real[np.argsort(ids[real], kind="stable")]
    lengths = np.bincount(ids[real], minlength=V)[:V]
    check_lengths(lengths, order.size)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    segments = t(np.append(lengths, 0).astype(np.int64))
    return ExchangeIndex(
        ids=t(ids), order=t(order), lengths=segments[:V], valid=t(valid), segments=segments
    )


def _build_host(
    buckets: Sequence[dict],
    counts: np.ndarray,
    nr_vars: int,
    nr_primal_vars: int,
    nr_bdds: int,
    dtype: torch.dtype,
    device,
) -> UniformHost:
    device = resolve_device(device)

    def t(x, dt):
        return torch.from_numpy(np.array(x, dtype=dt)).to(device)  # owned copy

    shapes = [b["node_valid"].shape for b in buckets]
    _check_device_memory([(P, H, B) for H, P, B in shapes],
                         torch.empty((), dtype=dtype).element_size(), device)
    plan = launch_plan([(P, H, B) for H, P, B in shapes], dtype, device)
    arcs_np = np.zeros(plan.arc_bytes, dtype=np.uint8)
    for b, off in zip(buckets, plan.arc_offsets):
        lv = np.asarray(b["layer_valid"], bool)
        rec = encode_arcs(*(b[k] for k in _NODE_KEYS), lv, root_rows(lv, b["root_mask"]))
        arcs_np[off:off + rec.size] = rec.ravel()
    arcs = torch.from_numpy(arcs_np).to(device)
    alpha_np = [np.asarray(b["alpha"], np.float64).ravel() for b in buckets]
    alpha = t(np.concatenate(alpha_np) if alpha_np else np.zeros(0), np.float64).to(dtype)
    geoms = []
    for b, (H, P, B), off, a in zip(buckets, shapes, plan.arc_offsets, alpha.split(
            [H * B for H, _, B in shapes])):
        G = record_bytes(P)
        geoms.append(BucketGeom(
            P=P,
            arcs=arcs[off:off + H * B * G].view(H, B, G),
            layer_var=t(b["layer_var"], np.int64),
            alpha=a.view(H, B),
            packed=b["root_mask"] is not None,
        ))
    geom = UniformGeom(
        buckets=tuple(geoms),
        num_bdds_per_var=t(counts, np.int64),
        exchange=_exchange_index(buckets, nr_vars, device),
        dtype=dtype,
        device=device,
        arcs=arcs,
        alpha=alpha,
        plan=plan,
        huge_scratch=huge_scratch(plan, device),
    )
    return UniformHost(
        geom=geom,
        bdd_of_col=tuple(np.asarray(b["bdd_of_col"]) for b in buckets),
        depths=tuple(np.asarray(b["depths"]) for b in buckets),
        nr_vars=nr_vars,
        nr_primal_vars=nr_primal_vars,
        nr_bdds=nr_bdds,
        layer_bdd=tuple(np.asarray(b["layer_bdd"]) for b in buckets),
    )


def _host_buckets(host: UniformHost) -> List[dict]:
    """Back from a host's tensors to numpy bucket dicts."""
    out = []
    for k, g in enumerate(host.geom.buckets):
        out.append(dict(
            node_valid=g.node_valid.cpu().numpy(),
            lo_kind=g.lo_kind.cpu().numpy(),
            lo_slot=g.lo_slot.cpu().numpy(),
            hi_kind=g.hi_kind.cpu().numpy(),
            hi_slot=g.hi_slot.cpu().numpy(),
            layer_valid=g.layer_valid.cpu().numpy(),
            layer_var=g.layer_var.cpu().numpy().astype(np.int32),
            alpha=g.alpha.cpu().numpy().astype(np.float64),
            layer_bdd=host.layer_bdd[k],
            root_mask=None if g.root_mask is None else g.root_mask.cpu().numpy(),
            bdd_of_col=host.bdd_of_col[k],
            depths=host.depths[k],
        ))
    return out


def host_to_arrays(host: UniformHost) -> dict:
    """A host as numpy arrays (its buckets, per-variable counts and sizes),
    for a cache on disk or a copy in another float type or on another device:
    :func:`host_from_arrays` builds it back."""
    return {"buckets": _host_buckets(host),
            "counts": host.geom.num_bdds_per_var.cpu().numpy(), "nr_vars": host.nr_vars,
            "nr_primal_vars": host.nr_primal_vars, "nr_bdds": host.nr_bdds}


def host_from_arrays(arrays: dict, dtype=torch.float32, device="cuda") -> UniformHost:
    return _build_host(arrays["buckets"], arrays["counts"], arrays["nr_vars"],
                       arrays["nr_primal_vars"], arrays["nr_bdds"], dtype, device)


# ----------------------------------------------------------------- builders
def from_native_host(nh, dtype=torch.float32, device="cuda", pack=None) -> UniformHost:
    """Solver-ready host from a ``bdd_tpu_torch.native.NativeHost``, the
    counterpart of bdd_tpu's ``NativeHost.make_uniform_host``. ``pack`` defaults to
    column packing for float32 only, as in the JAX package."""
    buckets, counts = _native_buckets(nh)
    if pack is None:
        pack = dtype == torch.float32
    if pack and buckets:
        buckets = _pack_buckets(buckets, nh.nr_vars())
    V = nh.nr_vars()
    return _build_host(buckets, counts, V, V, nh.nr_bdds(), dtype, device)


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


MERGE_WORK = 8192  # buckets below this H*B work merge into the next depth


def _merge_small_buckets(groups: Dict[Tuple[int, int], List]) -> Dict[Tuple[int, int], List]:
    """Coalesce small same-width depth groups upward: any group with
    H * members < MERGE_WORK joins the next deeper bucket of the same slot
    width (uniform.py:57-74 of the JAX package; mirrors merge_small_buckets
    of the host library)."""
    out: Dict[Tuple[int, int], List] = {}
    for P in sorted({k[0] for k in groups}):
        hs = sorted(h for (p, h) in groups if p == P)
        carry: List = []
        for i, h in enumerate(hs):
            mem = carry + groups[(P, h)]
            if i + 1 < len(hs) and len(mem) * h < MERGE_WORK:
                carry = mem
            else:
                out[(P, h)] = mem
                carry = []
    return out


def flatten_uniform(collection, nr_vars: int, nr_primal_vars: Optional[int] = None,
                    dtype=torch.float32, device="cuda", pack=None,
                    lanes: int = 128, counts_override=None,
                    keep_bdds: Optional[Sequence[int]] = None) -> UniformHost:
    """Bucketed uniform layout of a QBDD ``BddCollection``: the Python
    pipeline's way to the layout that :func:`from_native_host` builds from the
    host library (uniform.py:699-839 of the JAX package, bucket for bucket:
    a bucket is keyed by the width rounded up to a power of two and the depth
    rounded to eighths of one). ``pack`` defaults to column packing for
    float32 only. ``lanes`` pads B as the JAX package does, so both build
    the same arrays (:func:`lane_pad`; huge buckets are not padded here).

    ``keep_bdds``: the BDD numbers to lay out (default all); ``layer_bdd``
    keeps their numbers in the whole collection. ``counts_override``: the
    per-variable BDD counts of the whole collection, which then set ``alpha``
    and ``num_bdds_per_var`` (the hybrid solve's device share); a variable
    with no slot here gets an empty exchange segment. With it, ``pack``
    defaults to no packing, as in the JAX package."""
    if nr_primal_vars is None:
        nr_primal_vars = nr_vars
    buckets, counts = flatten_buckets(collection, nr_vars, lanes, counts_override, keep_bdds)
    if pack is None:
        pack = dtype == torch.float32 and counts_override is None
    if pack and buckets:
        buckets = _pack_buckets(buckets, nr_vars)
    nr_bdds = len(keep_bdds) if keep_bdds is not None else collection.nr_bdds()
    return _build_host(buckets, counts, nr_vars, nr_primal_vars, nr_bdds, dtype, device)


def flatten_buckets(collection, nr_vars: int, lanes: int = 128, counts_override=None,
                    keep_bdds: Optional[Sequence[int]] = None) -> Tuple[List[dict], np.ndarray]:
    """The numpy half of :func:`flatten_uniform`: the unpacked bucket dicts
    of the BDDs ``keep_bdds`` (default all) and the per-variable BDD counts
    (``counts_override`` if given), nothing on a device."""
    from bdd_tpu_torch.bdd.collection import BOT, TOP

    bdd_nrs = list(keep_bdds) if keep_bdds is not None else list(range(collection.nr_bdds()))
    info = []  # (bucket_key, bdd_nr, levels, vars, slots, depth)
    for b in bdd_nrs:
        levels = collection.node_levels(b)
        depth = max(levels) + 1
        lvars = collection.level_variables(b)
        # slot assignment: nodes of (b, h) numbered in node order, root slot 0
        per_level: Dict[int, int] = {}
        slots = []
        for lvl in levels:
            s = per_level.get(lvl, 0)
            slots.append(s)
            per_level[lvl] = s + 1
        step = max(1, _pow2(depth) // 8)
        key = (_pow2(max(per_level.values())), _pad_to(depth, step))
        info.append((key, b, levels, lvars, slots, depth))
    members_of: Dict[Tuple[int, int], List] = {}
    for item in info:
        members_of.setdefault(item[0], []).append(item)
    members_of = _merge_small_buckets(members_of)

    if counts_override is not None:
        counts = np.asarray(counts_override, dtype=np.int32)
    else:
        counts = np.zeros(nr_vars, dtype=np.int32)
        for (_, _, _, lvars, _, _) in info:
            for v in lvars:
                counts[v] += 1
    counts_safe = np.maximum(counts, 1)

    buckets: List[dict] = []
    for key in sorted(members_of):
        members = members_of[key]
        P, H = key
        nB = len(members)
        B = lane_pad(nB, P, lanes)
        bk = dict(
            node_valid=np.zeros((H, P, B), dtype=bool),
            lo_kind=np.full((H, P, B), ARC_BOT, dtype=np.int32),
            lo_slot=np.zeros((H, P, B), dtype=np.int32),
            hi_kind=np.full((H, P, B), ARC_BOT, dtype=np.int32),
            hi_slot=np.zeros((H, P, B), dtype=np.int32),
            layer_valid=np.zeros((H, B), dtype=bool),
            layer_var=np.full((H, B), nr_vars, dtype=np.int32),
            layer_bdd=np.full((H, B), -1, dtype=np.int64),
            root_mask=None,
            bdd_of_col=np.full(B, -1, dtype=np.int64),
            depths=np.zeros(B, dtype=np.int32),
        )
        for col, (_, b, levels, lvars, slots, depth) in enumerate(members):
            bk["bdd_of_col"][col] = b
            bk["depths"][col] = depth
            s0, _ = collection.node_range(b)
            bk["layer_valid"][:depth, col] = True
            bk["layer_var"][:depth, col] = lvars[:depth]
            bk["layer_bdd"][:depth, col] = b
            for i_local, (lvl, slot) in enumerate(zip(levels, slots)):
                bk["node_valid"][lvl, slot, col] = True
                n_abs = s0 + i_local
                for child, kind_arr, slot_arr in (
                    (collection.lo[n_abs], bk["lo_kind"], bk["lo_slot"]),
                    (collection.hi[n_abs], bk["hi_kind"], bk["hi_slot"]),
                ):
                    if child == TOP:
                        kind_arr[lvl, slot, col] = ARC_TOP
                    elif child == BOT:
                        kind_arr[lvl, slot, col] = ARC_BOT
                    else:
                        kind_arr[lvl, slot, col] = ARC_INTERNAL
                        slot_arr[lvl, slot, col] = slots[child - s0]
        m = bk["layer_valid"]
        bk["alpha"] = np.zeros((H, B))
        bk["alpha"][m] = 1.0 / counts_safe[bk["layer_var"][m]]
        buckets.append(bk)
    return buckets, counts


def pack_uniform_host(host: UniformHost,
                      caps: Optional[Dict[Tuple[int, int], int]] = None) -> UniformHost:
    """Column-pack an unpacked host (uniform.pack_uniform_host); ``caps``: the
    column heights of :func:`choose_pack_caps`."""
    return _build_host(
        _pack_buckets(_host_buckets(host), host.nr_vars, caps),
        host.geom.num_bdds_per_var.cpu().numpy(),
        host.nr_vars,
        host.nr_primal_vars,
        host.nr_bdds,
        host.geom.dtype,
        host.geom.device,
    )


def from_jax_arrays(host, state=None, dtype=torch.float64, device="cpu"):
    """Carry a ``bdd_tpu`` ``UniformHost`` (and optionally its
    ``UniformState``) across to the port, so both sides compute on identical
    inputs. Reads the JAX types by attribute; any array-like leaves (numpy
    arrays included) work. Returns the port host, or (host, state)."""
    buckets = []
    for k, g in enumerate(host.geom.buckets):
        lv = np.asarray(g.layer_valid, dtype=bool)
        buckets.append(dict(
            node_valid=np.asarray(g.node_valid, dtype=bool),
            lo_kind=np.asarray(g.lo_kind),
            lo_slot=np.asarray(g.lo_slot),
            hi_kind=np.asarray(g.hi_kind),
            hi_slot=np.asarray(g.hi_slot),
            layer_valid=lv,
            layer_var=np.asarray(g.layer_var),
            alpha=np.asarray(g.alpha, dtype=np.float64),
            layer_bdd=(np.asarray(host.layer_bdd[k]) if host.layer_bdd
                       else np.full(lv.shape, -1, dtype=np.int64)),
            root_mask=None if g.root_mask is None else np.asarray(g.root_mask),
            bdd_of_col=np.asarray(host.bdd_of_col[k]),
            depths=np.asarray(host.depths[k]),
        ))
    port = _build_host(
        buckets,
        np.asarray(host.geom.num_bdds_per_var),
        host.nr_vars,
        host.nr_primal_vars,
        host.nr_bdds,
        dtype,
        device,
    )
    if state is None:
        return port
    dev = port.geom.device

    def t(xs):
        return tuple(torch.from_numpy(np.array(x)).to(dev, dtype) for x in xs)

    return port, state_from_buckets(
        port.geom, t(state.lo), t(state.hi), t(state.def_mm), t(state.cft))

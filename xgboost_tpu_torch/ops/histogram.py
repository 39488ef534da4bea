"""Level histograms and node statistics (port of
``xgboost_tpu/ops/histogram.py``).

Precision resolution, done once per tree by :func:`prepare_hist` from
the ``hist_precision`` parameter and the DEVICE of the tensors (the JAX
package asks its default backend at trace time):

- ``auto``: the int8 kernel on a GPU (the JAX package's TPU default),
  exact fp32 on the CPU;
- ``fp32`` / ``bf16`` / ``int8``: that mode on either device (int8
  becomes bf16 when N * 127 >= 2^31);
- ``fixed``: int32 fixed-point sums on either device.

A CUDA tensor runs the kernel, a CPU tensor its plain version: K1
(:mod:`.cuda_hist`) for one tree, K3 (:mod:`.cuda_hist_batched`) for
the T trees of a multiclass or forest round, K4
(:mod:`.cuda_hist_lanes`) for the L tenants of a gang-batched lane
stack, K2 (:mod:`.cuda_node_stats`) for node statistics.  Every
histogram is in the kernel's node-minor layout ``(F, B, 2, n_node)``
(``pallas_hist.py`` "native"), at every depth; a batched level is
``(F, B, 2, T * n_node)``, tree outer, and a lane level
``(F, B, 2, L * n_node)``, lane outer.

Row-split training (:mod:`xgboost_tpu_torch.parallel`) passes a
``reduce`` that sums a tensor of this rank's partial sums over the
ranks: every level histogram and node-stat tensor is reduced as the
kernel returns it, before dequantisation, so "fixed" and int8 reduce
their exact int32 sums and dequantise once (the JAX package's
``dequantize_hist(red(...))``).  int8 quantises every rank's rows on
one scale, the channel's ``max |gh|`` over all ranks
(``prepare_hist(scale_reduce=)``), so a level is bitwise the same at
any world size; the JAX package's TPU path quantises each shard on its
own scale (a deliberate difference, ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from xgboost_tpu_torch.ops import (cuda_hist, cuda_hist_batched,
                                   cuda_hist_lanes, cuda_node_stats)

# int8 sums dequantize with scale * (1/127): the JAX package writes
# scale / 127.0 (pallas_hist.py:268-270, :628-631), which XLA compiles to
# a multiply by the f32 reciprocal; a true division differs in the last
# bit for some scales.  A Python float operand is rounded to the f32
# tensor's type, and needs no host-to-device copy (which would wait for
# the stream).
_INV127 = 1.0 / 127.0

# hist_precision="fixed": gradients rounded to multiples of 1/FIXED_SCALE
# and summed in int32 — exactly associative, so sums are bitwise
# independent of the order of the rows (ops/histogram.py:105-114)
FIXED_SCALE = 2048.0


def resolve_mode(precision: str, device: torch.device, n_rows: int) -> str:
    """The histogram mode for ``hist_precision`` on ``device``:
    fp32 | bf16 | int8 | fixed."""
    if precision == "fixed":
        return "fixed"
    if precision == "auto":
        precision = "int8" if device.type == "cuda" else "fp32"
    if precision not in ("fp32", "bf16", "int8"):
        raise ValueError(f"hist_precision={precision!r}: expected auto, "
                         "fp32, bf16, int8 or fixed")
    return cuda_hist.resolve_precision(precision, n_rows)


class HistPrep(NamedTuple):
    """Once-per-tree operands of the level loop: the gradients in the
    kernel's input form (f32, or int32 with ``scale`` in int8 mode)."""
    gh_in: torch.Tensor          # (N, 2), or (T, N, 2) for T trees or lanes
    scale: Optional[torch.Tensor]  # (2,), or per tree or lane (T, 2)
    mode: str                    # fp32 | bf16 | int8 | fixed


def prepare_hist(gh: torch.Tensor, precision: str, n_rows: int = 0,
                 scale_reduce=None) -> HistPrep:
    """Quantize (int8, fixed) or keep (fp32, bf16) the tree's (N, 2)
    gradients, or T trees' or L lanes' (T, N, 2) (int8 scales per tree
    or lane), once for every level.  ``n_rows`` (default N) is the row
    count the int8 sums must hold, all ranks' under row split;
    ``scale_reduce`` takes the int8 channel maxima to their maxima over
    the ranks."""
    mode = resolve_mode(precision, gh.device, max(n_rows, gh.shape[-2]))
    if mode == "int8":
        gh_q, scale = cuda_hist.quantize_gh(gh, scale_reduce)
        return HistPrep(gh_q.contiguous(), scale, mode)
    if mode == "fixed":
        q = torch.round(gh * FIXED_SCALE).to(torch.int32)
        return HistPrep(q.contiguous(), None, mode)
    return HistPrep(gh.to(torch.float32).contiguous(), None, mode)


def _reduced(hist: torch.Tensor, reduce) -> torch.Tensor:
    return hist if reduce is None else reduce(hist)


def build_level_histogram(binned: torch.Tensor, prep: HistPrep,
                          pos: torch.Tensor, n_node: int,
                          n_bin: int, reduce=None) -> torch.Tensor:
    """Per-(feature, bin, channel, node) grad/hess sums of one level,
    f32 ``(F, n_bin, 2, n_node)``.  ``pos`` (N,) int32 is each row's
    level-local node, -1 = inactive.  int8 and fixed sums come back
    dequantized, after ``reduce``."""
    hist = _reduced(cuda_hist.level_histogram(
        binned, prep.gh_in, pos, n_node, n_bin, _KMODE[prep.mode]), reduce)
    if prep.mode == "int8":
        # the exact int32 sums back to f32 (pallas_hist.py:268-270)
        return hist.to(torch.float32) * _int8_step(prep.scale)[None, None, :,
                                                               None]
    return dequantize_hist(hist)


def build_level_histogram_batched(binned: torch.Tensor, prep: HistPrep,
                                  pos: torch.Tensor, n_node: int,
                                  n_bin: int, reduce=None) -> torch.Tensor:
    """The level histograms of T trees on shared bins in one launch of
    K3: f32 ``(F, n_bin, 2, T * n_node)``, tree outer.  ``prep`` holds
    (T, N, 2) gradients; ``pos`` (T, N) int32 is each tree's level-local
    node per row, -1 = inactive.  int8 sums come back dequantized with
    each tree's scales (``pallas_hist.py:628-631``), fixed sums with
    FIXED_SCALE."""
    hist = _reduced(cuda_hist_batched.level_histogram_batched(
        binned, prep.gh_in, pos, n_node, n_bin, _KMODE[prep.mode]), reduce)
    return _dequantize_columns(hist, prep, n_node)


def build_level_histogram_lanes(binned: torch.Tensor, prep: HistPrep,
                                pos: torch.Tensor, n_node: int,
                                n_bin: int, reduce=None) -> torch.Tensor:
    """The level histograms of L tenant lanes, each on its own bins, in
    one launch of K4: binned (L, N, F), ``prep`` holding (L, N, 2)
    gradients, ``pos`` (L, N) int32 (-1 = inactive, pad rows and pad
    lanes included) -> f32 ``(F, n_bin, 2, L * n_node)``, lane outer.
    int8 sums come back dequantized with each lane's scales
    (``pallas_hist.py:337-346``), fixed sums with FIXED_SCALE."""
    hist = _reduced(cuda_hist_lanes.level_histogram_lanes(
        binned, prep.gh_in, pos, n_node, n_bin, _KMODE[prep.mode]), reduce)
    return _dequantize_columns(hist, prep, n_node)


_KMODE = {"fp32": "fp32", "bf16": "bf16", "int8": "int", "fixed": "int"}


def _dequantize_columns(hist: torch.Tensor, prep: HistPrep,
                        n_node: int) -> torch.Tensor:
    """A ``(F, B, 2, T * n_node)`` kernel result back to f32: int8 with
    each tree's or lane's (T, 2) scales on its columns, fixed with
    FIXED_SCALE, floats as they are."""
    if prep.mode == "int8":
        # per-tree (T, 2) scales onto the (2, T * n_node) channel x column
        T = prep.scale.shape[0]
        mult = _int8_step(prep.scale).T[:, :, None].expand(2, T, n_node)
        return hist.to(torch.float32) * mult.reshape(2, T * n_node)[None,
                                                                    None]
    return dequantize_hist(hist)


def _int8_step(scale: torch.Tensor) -> torch.Tensor:
    """The value of one int8 step, ``scale * f32(1/127)``."""
    return scale * _INV127


def dequantize_hist(hist: torch.Tensor) -> torch.Tensor:
    """Undo the "fixed" int32 encoding (identity on float tensors)."""
    if not hist.dtype.is_floating_point:
        # 1/FIXED_SCALE is a power of two: exact in f32
        return hist.to(torch.float32) * (1.0 / FIXED_SCALE)
    return hist


def node_stats(gh: torch.Tensor, pos: torch.Tensor, n_node: int,
               precision: str = "auto", reduce=None) -> torch.Tensor:
    """Per-node (G, H) sums: gh (N, 2) and pos (N,) -> (n_node, 2), or
    with a leading tree axis (T, N, 2) and (T, N) -> (T, n_node, 2), f32.
    Runs wherever the split finder leaves no sums behind: the terminal
    level of depth-0 and skmaker trees, every level of exact
    (``grow_colmaker``) growth, every level of a ``refresh`` pass (all
    trees in one call), and the row counts of histogram subtraction.
    K2 on a GPU, its plain version on the CPU; "fixed" precision is the
    JAX package's plain int32 scatter on every device
    (``ops/histogram.py:304-308``).  ``reduce`` sums the sums over the
    ranks before "fixed" dequantises."""
    if gh.dim() == 2:
        return node_stats(gh[None], pos[None], n_node, precision,
                          reduce)[0]
    if precision == "fixed":
        q = torch.round(gh * FIXED_SCALE).to(torch.int32)
        T = gh.shape[0]
        slot = torch.where(pos < 0, n_node, pos).to(torch.int64)
        idx = slot + (n_node + 1) * torch.arange(
            T, dtype=torch.int64, device=gh.device)[:, None]
        out = torch.zeros((T * (n_node + 1), 2), dtype=torch.int32,
                          device=gh.device)
        out.index_add_(0, idx.reshape(-1), q.reshape(-1, 2))
        return dequantize_hist(_reduced(
            out.reshape(T, n_node + 1, 2)[:, :n_node], reduce))
    return _reduced(cuda_node_stats.node_stats(
        gh.to(torch.float32).contiguous(), pos.to(torch.int32).contiguous(),
        n_node), reduce)


def bin_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (bin) axis.  On the CPU in XLA's CPU order, so
    node totals match the JAX package's CPU run bit for bit: an axis of
    n <= 32 is added left to right from 0; a longer one is padded with
    zeros to a multiple of 32 (half the pad in front, the odd one
    behind), each run of 32 added left to right, and the runs' sums
    reduced the same way (XLA's CPU tree-reduction rewrite).  On the GPU
    one reduction (the JAX package's TPU order is neither)."""
    if x.device.type != "cpu":
        return x.sum(dim=-1)
    B = x.shape[-1]
    if B > 32:
        total = -(-B // 32) * 32
        front = (total - B) // 2
        x = torch.nn.functional.pad(x, (front, total - B - front))
        x = x.reshape(*x.shape[:-1], total // 32, 32)
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return bin_sum(acc) if B > 32 else acc


def stats_from_histogram_native(hist: torch.Tensor) -> torch.Tensor:
    """Per-node (G, H) totals from ``(F, B, 2, n_node)``: the bin sums of
    feature 0 (every active row lands in one bin of every feature),
    each node's over its own contiguous bin axis (:func:`bin_sum`): a
    node's total is then the same bits whatever the number of nodes
    beside it, so T trees' batched level equals T solo levels."""
    return bin_sum(hist[0].permute(2, 1, 0).contiguous())


def stats_from_histogram(hist: torch.Tensor) -> torch.Tensor:
    """The same from the standard ``(n_node, F, B, 2)`` layout."""
    return bin_sum(hist[:, 0, :, :].transpose(1, 2))

"""Plain torch oracle for the CiM bit-plane logic engine.

Semantics contract shared with kernels/cim_logic.py:

  * Signals live in a register file of ``n_rows`` bit-plane rows; each row
    holds ``n_words`` int32 words = 32*n_words packed test vectors.
  * Primary inputs occupy rows [0, n_pis).
  * Instructions are int32 arrays (n_gates, 4): [kind, a_row, b_row, out_row]
    with kind 0 = NAND2, 1 = NOR2, 2 = NOT (b ignored, = a).
  * Outputs are gathered from ``po_rows`` after all instructions retire.

This mirrors the paper's execution model: one instruction = one sense-amp
op (two wordline activations + resonant writeback to a row).
`cim_reference` is the plain version the K2 wrapper runs on CPU tensors
and the one the kernel is held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def cim_reference(
    instrs: torch.Tensor,  # (n_gates, 4) int32
    pi_planes: torch.Tensor,  # (n_pis, n_words) int32
    po_rows: torch.Tensor,  # (n_pos,) int32
    n_rows: int,
) -> torch.Tensor:
    """Evaluate the instruction stream — a loop over instructions,
    vectorized over words; returns (n_pos, n_words) int32 on the planes'
    device."""
    n_pis, n_words = pi_planes.shape
    regs = torch.zeros((n_rows, n_words), dtype=torch.int32, device=pi_planes.device)
    regs[:n_pis] = pi_planes.to(torch.int32)
    for kind, a, b, o in instrs.tolist():
        if kind == 1:
            regs[o] = ~(regs[a] | regs[b])
        else:
            regs[o] = ~(regs[a] & regs[b])
    return regs[po_rows.long()]


def pack_vectors(bits: np.ndarray) -> np.ndarray:
    """Pack (n_signals, n_vectors) {0,1} -> (n_signals, ceil(n/32)) int32.

    Vector v maps to bit (v % 32) of word (v // 32), LSB-first.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    n_sig, n_vec = bits.shape
    n_words = -(-n_vec // 32)
    padded = np.zeros((n_sig, n_words * 32), dtype=np.uint8)
    padded[:, :n_vec] = bits
    out = np.zeros((n_sig, n_words), dtype=np.uint32)
    for b in range(32):
        out |= padded[:, b::32].astype(np.uint32) << np.uint32(b)
    return out.view(np.int32)


def unpack_vectors(words: np.ndarray, n_vec: int) -> np.ndarray:
    """Inverse of pack_vectors -> (n_signals, n_vec) uint8."""
    w = np.asarray(words).view(np.uint32)
    n_sig, n_words = w.shape
    bits = np.zeros((n_sig, n_words * 32), dtype=np.uint8)
    for b in range(32):
        bits[:, b::32] = ((w >> np.uint32(b)) & np.uint32(1)).astype(np.uint8)
    return bits[:, :n_vec]

"""Per-tick packet emission staging (counterpart of
shadow1_tpu/core/emit.py).

Each emission category has a fixed lane of a dense [H, E] buffer, in the
packed outbox column layout (state.OCOL_* / ICOL_*); the engine later
patches the columns only it can know (SRC, CTR, TIME, LAT)."""

from __future__ import annotations

import dataclasses

import torch

from .state import (I32, I64, ICOLS, ICOL_SPORT, ICOL_DPORT, ICOL_PROTO,
                    ICOL_FLAGS, ICOL_SEQ, ICOL_ACK, ICOL_WND, ICOL_LEN,
                    ICOL_PAYLOAD, ICOL_SACK0_LO, ICOL_TIME_LO, ICOL_TIME_HI,
                    ICOL_TSE_LO, ICOL_TSE_HI, OEXT_DST, OEXT_PRIO,
                    SACK_BLOCKS, Tree, dec_i64, enc_hi, enc_lo, ext_base)

SLOT_RX_REPLY = 0
SLOT_TIMER = 1
SLOT_APP = 2
SLOT_TX_BASE = 3
TX_SLOTS = 4
NUM_SLOTS = SLOT_TX_BASE + TX_SLOTS


@dataclasses.dataclass
class Emissions(Tree):
    """[H, E] staged outgoing packets, packed column format."""

    valid: torch.Tensor    # [H, E] bool
    blk: torch.Tensor      # [H, E, C] i32

    @property
    def dst(self):
        return self.blk[:, :, ext_base(self.blk.shape[-1]) + OEXT_DST]

    @property
    def proto(self):
        return self.blk[:, :, ICOL_PROTO]

    @property
    def length(self):
        return self.blk[:, :, ICOL_LEN]

    @property
    def t_send(self):
        return dec_i64(self.blk[:, :, ICOL_TIME_LO],
                       self.blk[:, :, ICOL_TIME_HI])


def empty(num_hosts: int, num_slots: int, cols: int, device) -> Emissions:
    he = (num_hosts, num_slots)
    return Emissions(
        valid=torch.zeros(he, dtype=torch.bool, device=device),
        blk=torch.zeros(he + (cols,), dtype=I32, device=device))


def _col(x, h, dtype, device):
    """A scalar or [H] field value as an [H] int32 column (through its
    natural dtype, like the JAX put's casts)."""
    if isinstance(x, torch.Tensor):
        v = x.to(dtype)
    else:
        v = torch.tensor(x, dtype=dtype, device=device)
    return torch.broadcast_to(v, (h,)).to(I32)


def put(em: Emissions, mask: torch.Tensor, slot: int, *, dst, sport, dport,
        proto, flags=0, seq=0, ack=0, wnd=0, length=0, ts_echo=0,
        t_send=0, sack_lo=None, sack_hi=None, payload_id=-1,
        priority=0.0) -> Emissions:
    """For hosts where `mask` is set, stage one packet in lane `slot`.
    The TCP-only columns (TSE, SACK) exist only in full-width blocks, as
    in the JAX put.  `seq`/`ack` and the [H, SACK_BLOCKS] (or
    [SACK_BLOCKS]) `sack_lo`/`sack_hi` are uint32 values held in int64."""
    h = em.valid.shape[0]
    dev = em.blk.device
    width = em.blk.shape[-1]
    base = ext_base(width)
    cols = [torch.zeros((h,), dtype=I32, device=dev)] * width
    cols[ICOL_SPORT] = _col(sport, h, I32, dev)
    cols[ICOL_DPORT] = _col(dport, h, I32, dev)
    cols[ICOL_PROTO] = _col(proto, h, I32, dev)
    cols[ICOL_FLAGS] = _col(flags, h, I32, dev)
    # uint32 -> int32 bitcast == two's-complement truncation of the int64.
    cols[ICOL_SEQ] = _col(seq, h, I64, dev)
    cols[ICOL_ACK] = _col(ack, h, I64, dev)
    cols[ICOL_WND] = _col(wnd, h, I32, dev)
    cols[ICOL_LEN] = _col(length, h, I32, dev)
    cols[ICOL_PAYLOAD] = _col(payload_id, h, I32, dev)
    ts64 = torch.broadcast_to(torch.as_tensor(t_send, dtype=I64, device=dev),
                              (h,))
    cols[ICOL_TIME_LO] = enc_lo(ts64)
    cols[ICOL_TIME_HI] = enc_hi(ts64)
    if base >= ICOLS:
        tse = torch.broadcast_to(torch.as_tensor(ts_echo, dtype=I64,
                                                 device=dev), (h,))
        cols[ICOL_TSE_LO] = enc_lo(tse)
        cols[ICOL_TSE_HI] = enc_hi(tse)
        if sack_lo is not None:
            slo = torch.as_tensor(sack_lo, dtype=I64, device=dev)
            shi = torch.as_tensor(sack_hi, dtype=I64, device=dev)
            slo = torch.broadcast_to(slo, (h, SACK_BLOCKS))
            shi = torch.broadcast_to(shi, (h, SACK_BLOCKS))
            for i in range(SACK_BLOCKS):
                cols[ICOL_SACK0_LO + 2 * i] = slo[:, i].to(I32)
                cols[ICOL_SACK0_LO + 2 * i + 1] = shi[:, i].to(I32)
    elif sack_lo is not None:
        raise ValueError("SACK blocks need a full-width (TCP) emission "
                         "block; this world staged a narrow one")
    cols[base + OEXT_DST] = _col(dst, h, I32, dev)
    prio = torch.broadcast_to(torch.as_tensor(priority, dtype=torch.float32,
                                              device=dev), (h,))
    cols[base + OEXT_PRIO] = prio.contiguous().view(I32)
    row = torch.stack(cols, dim=1)                        # [H, C]
    blk = em.blk.clone()
    blk[:, slot, :] = torch.where(mask[:, None], row, em.blk[:, slot, :])
    valid = em.valid.clone()
    valid[:, slot] = mask | em.valid[:, slot]
    return Emissions(valid=valid, blk=blk)

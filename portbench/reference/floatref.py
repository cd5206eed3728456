"""The plain float codec: the archive dietgpu's float codec writes, in torch.

This is the benchmark's reference for the float archives of the program
under test. It follows the archive format of facebookresearch/dietgpu
(``GpuFloatCompress.cuh``, ``GpuANSUtils.cuh``) as the NumPy oracle of the
JAX package writes it, and imports nothing of the program: its own
constants, its own split, its own histogram quantization and an rANS
encoder that divides exactly where the kernels multiply by a magic number.

The float container (little-endian):

    u32 magic 0xF00F << 16 | 1, u32 words, u32 options (float type | checksum << 4),
    u32 checksum; the raw plane(s): f16/bf16 one byte a word (round_up(n, 16)
    bytes), f32 a u16 plane (round_up(n, 8) entries) then a u8 plane
    (round_up(n, 16)); then the ANS archive of the exponent bytes.

The ANS archive: a 32-byte header (magic 0xD00D << 16 | 1, blocks, bytes,
payload u16 words, prob_bits | checksum << 4, checksum, 0, 0), 256 u16
probabilities, 32 u32 final states a 4 KiB block, round_up(blocks, 2)
(x, y) pairs ((bytes << 16) | u16 words, payload offset), then each
block's u16 words padded to a multiple of 8. Lane l of a block codes its
bytes l, l + 32, ...; a lane whose state reaches pdf << (31 - prob_bits)
first flushes its low 16 bits, and the flushed words of a step go out in
lane order.

Everything runs on the device of the words handed in, in blocks of
``CHUNK_BLOCKS`` 4 KiB blocks, so that 2^29 words fit beside what a run
keeps.
"""

import numpy as np
import torch

BLOCK = 4096
LANES = 32
STEPS = BLOCK // LANES
START_STATE = 1 << 15
STATE_BITS = 31
MAX_BLOCK_WORDS = (BLOCK + BLOCK // 4) // 2  # 2560 u16 words a block at most
ANS_MAGIC, ANS_VERSION = 0xD00D, 1
FLOAT_MAGIC, FLOAT_VERSION = 0xF00F, 1
FLOAT16, BFLOAT16, FLOAT32 = 1, 2, 3
CHUNK_BLOCKS = 16384  # 64Mi symbols a pass


def round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _i32(values) -> torch.Tensor:
    """u32 values (Python ints or an int64 tensor) as int32 bits."""
    v = torch.as_tensor(values, dtype=torch.int64)
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def _i16(v: torch.Tensor) -> torch.Tensor:
    """u16 values (an integer tensor) as int16 bits."""
    v = v.to(torch.int32)
    return ((v ^ 0x8000) - 0x8000).to(torch.int16)


def plane_bytes(float_type: int, n: int) -> int:
    if float_type == FLOAT32:
        return 2 * round_up(n, 8) + round_up(n, 16)
    return round_up(n, 16)


def split(words: torch.Tensor, float_type: int):
    """(exponent bytes (n,) uint8, raw plane bytes uint8) of n words:
    int16 words for f16/bf16, int32 for f32."""
    n = words.numel()
    dev = words.device
    comp = torch.empty(n, dtype=torch.uint8, device=dev)
    plane = torch.zeros(plane_bytes(float_type, n), dtype=torch.uint8, device=dev)
    lo_entries = round_up(n, 8)
    step = CHUNK_BLOCKS * BLOCK
    for a in range(0, n, step):
        b = min(n, a + step)
        if float_type == FLOAT32:
            w = words[a:b].to(torch.int64) & 0xFFFFFFFF
            v = ((w << 1) | (w >> 31)) & 0xFFFFFFFF
            comp[a:b] = (v >> 24).to(torch.uint8)
            plane[: 2 * lo_entries].view(torch.int16)[a:b] = _i16(v & 0xFFFF)
            plane[2 * lo_entries + a : 2 * lo_entries + b] = ((v >> 16) & 0xFF).to(torch.uint8)
        else:
            w = words[a:b].to(torch.int32) & 0xFFFF
            if float_type == BFLOAT16:
                w = ((w << 1) | (w >> 15)) & 0xFFFF
            comp[a:b] = (w >> 8).to(torch.uint8)
            plane[a:b] = (w & 0xFF).to(torch.uint8)
    return comp, plane


def normalize_probs(hist: np.ndarray, total: int, prob_bits: int) -> np.ndarray:
    """dietgpu's quantization of a histogram to weights that sum to
    2^prob_bits (GpuANSStatistics.cuh:179-367): f32 ratio, truncation,
    present symbols at least 1; a deficit adds by symbol value, an excess
    takes 1 from the smallest weights above 1 in the descending order of
    (weight << 16) | symbol."""
    K = 1 << prob_bits
    if total == 0:
        return np.zeros(256, dtype=np.int64)
    ratio = hist.astype(np.float32) / np.float32(total)
    q = (np.float32(K) * ratio).astype(np.int64)
    q = np.where((hist > 0) & (q == 0), 1, q)
    diff = K - int(q.sum())
    sym = np.arange(256, dtype=np.int64)
    if diff > 0:
        q = q + diff // 256 + (sym < diff % 256)
    elif diff < 0:
        order = np.argsort(-((q << 16) | sym), kind="stable")
        vals = q[order].copy()
        need = -diff
        while need > 0:
            above = int((vals > 1).sum())
            take = min(need, above)
            if take == 0:
                raise ValueError("normalize_probs: the weights cannot shrink further")
            vals[above - take : above] -= 1
            need -= take
        q = np.zeros(256, dtype=np.int64)
        q[order] = vals
    if int(q.sum()) != K:
        raise AssertionError("normalize_probs: weights do not sum to 2^prob_bits")
    return q


def _encode_blocks(syms, n_valid, pdf_t, cdf_t, prob_bits):
    """Encode (cb, 4096) exponent bytes, the first `n_valid` of the flat
    chunk coded: (final states (cb, 32) int64, u16 words a block (cb,),
    each block's words in stream order (cb, 2560) int16)."""
    cb = syms.shape[0]
    dev = syms.device
    s3 = syms.view(cb, STEPS, LANES).long()
    valid = None
    if n_valid < cb * BLOCK:
        valid = (torch.arange(cb * BLOCK, device=dev) < n_valid).view(cb, STEPS, LANES)
    state = torch.full((cb, LANES), START_STATE, dtype=torch.int64, device=dev)
    vals = torch.zeros((cb, STEPS, LANES), dtype=torch.int32, device=dev)
    flush = torch.zeros((cb, STEPS, LANES), dtype=torch.bool, device=dev)
    shift = STATE_BITS - prob_bits
    for k in range(STEPS):
        s = s3[:, k]
        p = pdf_t[s]
        out = state >= (p << shift)
        if valid is not None:
            out &= valid[:, k]
        vals[:, k] = torch.where(out, state & 0xFFFF, 0).to(torch.int32)
        flush[:, k] = out
        state = torch.where(out, state >> 16, state)
        d = torch.div(state, p.clamp(min=1), rounding_mode="floor")
        nxt = (d << prob_bits) + (state - d * p) + cdf_t[s]
        state = nxt if valid is None else torch.where(valid[:, k], nxt, state)
    flush = flush.view(cb, BLOCK)
    words = flush.sum(1)
    order = torch.sort((~flush).to(torch.uint8), dim=1, stable=True).indices[:, :MAX_BLOCK_WORDS]
    stream = torch.gather(vals.view(cb, BLOCK), 1, order)
    return state, words, _i16(stream)


def ans_archive(data: torch.Tensor, prob_bits: int) -> torch.Tensor:
    """The ANS archive of bytes `data` ((n,) uint8), no checksum, as
    uint8 (its exact size)."""
    n = data.numel()
    dev = data.device
    nb = -(-n // BLOCK)
    hist = torch.bincount(data.long(), minlength=256).cpu().numpy()
    pdf = normalize_probs(hist, n, prob_bits)
    cdf = np.concatenate([[0], np.cumsum(pdf)[:-1]])
    pdf_t = torch.from_numpy(pdf).to(dev)
    cdf_t = torch.from_numpy(cdf).to(dev)

    states = torch.empty((nb, LANES), dtype=torch.int64, device=dev)
    words = torch.empty(nb, dtype=torch.int64, device=dev)
    streams = torch.empty((nb, MAX_BLOCK_WORDS), dtype=torch.int16, device=dev)
    for b0 in range(0, nb, CHUNK_BLOCKS):
        b1 = min(nb, b0 + CHUNK_BLOCKS)
        chunk = data[b0 * BLOCK : min(n, b1 * BLOCK)]
        if chunk.numel() < (b1 - b0) * BLOCK:
            chunk = torch.cat([chunk, chunk.new_zeros((b1 - b0) * BLOCK - chunk.numel())])
        st, w, stream = _encode_blocks(
            chunk.view(b1 - b0, BLOCK), min(n, b1 * BLOCK) - b0 * BLOCK, pdf_t, cdf_t, prob_bits)
        states[b0:b1], words[b0:b1], streams[b0:b1] = st, w, stream
    if nb and int(words.max()) > MAX_BLOCK_WORDS:
        raise OverflowError("a block's payload exceeds its bound")
    padded = (words + 7) // 8 * 8
    prefix = torch.cumsum(padded, 0) - padded
    total = int(padded.sum()) if nb else 0

    head = 32 + 512 + 128 * nb + 8 * round_up(nb, 2)
    arc = torch.zeros(head + 2 * total, dtype=torch.uint8, device=dev)
    arc[:32].view(torch.int32)[:] = _i32(
        [(ANS_MAGIC << 16) | ANS_VERSION, nb, n, total, prob_bits & 0xF, 0, 0, 0]).to(dev)
    arc[32:544].view(torch.int16)[:] = _i16(pdf_t)
    arc[544 : 544 + 128 * nb].view(torch.int32)[:] = states.reshape(-1).to(torch.int32)
    if nb:
        uncomp = torch.full((nb,), BLOCK, dtype=torch.int64, device=dev)
        uncomp[-1] = n - (nb - 1) * BLOCK
        pairs = arc[544 + 128 * nb : head].view(torch.int32).view(-1, 2)
        pairs[:nb, 0] = ((uncomp << 16) | words).to(torch.int32)
        pairs[:nb, 1] = prefix.to(torch.int32)
    payload = arc[head:].view(torch.int16)
    cols = torch.arange(MAX_BLOCK_WORDS, device=dev)
    for b0 in range(0, nb, CHUNK_BLOCKS):
        b1 = min(nb, b0 + CHUNK_BLOCKS)
        keep = cols[None, :] < padded[b0:b1, None]
        dst = prefix[b0:b1, None] + cols[None, :]
        payload[dst[keep]] = streams[b0:b1][keep]
    return arc


def float_archive(words: torch.Tensor, float_type: int, prob_bits: int) -> torch.Tensor:
    """The float archive of `words` (1-D: int16 for f16/bf16, int32 for
    f32), no checksum, as uint8 (its exact size)."""
    if float_type not in (FLOAT16, BFLOAT16, FLOAT32):
        raise ValueError(f"float type {float_type} is not f16/bf16/f32")
    n = words.numel()
    comp, plane = split(words, float_type)
    ans = ans_archive(comp, prob_bits)
    del comp
    out = torch.empty(16 + plane.numel() + ans.numel(), dtype=torch.uint8, device=words.device)
    out[:16].view(torch.int32)[:] = _i32(
        [(FLOAT_MAGIC << 16) | FLOAT_VERSION, n, float_type & 0xF, 0]).to(words.device)
    out[16 : 16 + plane.numel()] = plane
    out[16 + plane.numel() :] = ans
    return out

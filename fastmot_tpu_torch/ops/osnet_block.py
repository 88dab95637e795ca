"""One OSNet residual block (OSBlock) as one CUDA kernel launch.

Port of ``fastmot_tpu/ops/osnet_block.py``. The pieces:

- ``fold_osblock``: one block's weights, folded BN included, as the flat
  argument list of the TPU kernel (same order, layouts and dtypes).
- ``osblock_reference``: the plain PyTorch version, with the TPU kernel's
  rounding (bf16 after each 1x1 conv, inside the folded BN and on each
  LiteConv output; f32 depthwise taps, f32 gate, f32 gated sum).
- ``pack_osblock`` / ``unpack_osblock``: the flat list in the kernel's
  layout, two buffers: the 1x1 matrices as bf16 16x8 tiles in mma fragment
  order, and every vector (BN, depthwise taps, gate) as f32.
- ``launch_plan``: the cluster size, band rows and shared memory of a
  launch, from the shapes and the card's shared-memory limit (no CUDA
  calls).
- ``osblock``: the wrapper the model calls. On a CUDA tensor it launches
  ``csrc/osnet_block.cu`` (built at first use) or raises; on a CPU tensor
  it runs the plain version. ``osblock.launches`` counts kernel launches.

Activations are NHWC: x ``[B, H, W, C_in]``, output ``[B, H, W, F]`` bf16.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

BN_EPS = 1e-5
# csrc/osnet_block.cu: threads per CTA, warps, output channels per conv3
# epilogue chunk, the mids it is instantiated for, the largest cluster
THREADS, WARPS, CHUNK_F = 256, 8, 32
KERNEL_MIDS = (16, 24, 32, 64, 96, 128)
MAX_CLUSTER = 8
MIN_CTAS = 128          # fill the H100's 132 SMs with one wave
H100_SMEM = 232448      # opt-in shared memory per block on an H100


def block_dims(features: int) -> tuple[int, int]:
    """(mid, hid): the streams' width and the gate's hidden width."""
    mid = max(features // 4, 4)
    return mid, max(mid // 16, 1)


def _fold_bn(sd, prefix):
    gamma = sd[f'{prefix}.weight'].float()
    beta = sd[f'{prefix}.bias'].float()
    mean = sd[f'{prefix}.running_mean'].float()
    var = sd[f'{prefix}.running_var'].float()
    scale = gamma / torch.sqrt(var + BN_EPS)
    return scale, beta - mean * scale


def fold_osblock(sd, ch_in: int, features: int) -> list[torch.Tensor]:
    """Flatten one OSBlock's state dict (the port's module names) into the
    TPU kernel's argument list:

    ``w1 [C_in, mid], sc1, sh1 [mid, 1]`` (bf16); per LiteConv 0..9
    ``wp [mid, mid]`` (bf16), ``dw [9, mid]`` (f32 holding bf16 values),
    ``sc, sh [mid, 1]`` (bf16); the gate's ``gw1 [mid, hid], gb1 [hid, 1],
    gw2 [hid, mid], gb2 [mid, 1]`` (f32); ``w3 [mid, F], sc3, sh3`` (bf16);
    and, when ``C_in != F``, the downsample ``wd [C_in, F], scd, shd``."""
    mid, _ = block_dims(features)
    bf16 = torch.bfloat16

    def convbn(name):
        w = sd[f'{name}.Conv_0.weight'].float()          # [out, in, 1, 1]
        sc, sh = _fold_bn(sd, f'{name}.BatchNorm_0')
        return [w[:, :, 0, 0].T.to(bf16), sc[:, None].to(bf16),
                sh[:, None].to(bf16)]

    args = convbn('ConvBNReLU_0')
    for i in range(10):
        pre = f'LiteConv_{i}'
        wp = sd[f'{pre}.Conv_0.weight'].float()[:, :, 0, 0].T
        dw = sd[f'{pre}.DepthwiseConv3x3_0.weight'].float()   # [mid,1,3,3]
        sc, sh = _fold_bn(sd, f'{pre}.BatchNorm_0')
        args += [wp.to(bf16),
                 dw.reshape(mid, 9).T.contiguous().to(bf16).float(),
                 sc[:, None].to(bf16), sh[:, None].to(bf16)]
    g = 'AggregationGate_0'
    args += [sd[f'{g}.Dense_0.weight'].float().T.contiguous(),
             sd[f'{g}.Dense_0.bias'].float()[:, None],
             sd[f'{g}.Dense_1.weight'].float().T.contiguous(),
             sd[f'{g}.Dense_1.bias'].float()[:, None]]
    args += convbn('ConvBNReLU_1')
    if ch_in != features:
        args += convbn('ConvBNReLU_2')
    return args


def osblock_reference(x: torch.Tensor, flat: list[torch.Tensor],
                      ch_in: int, features: int) -> torch.Tensor:
    """Plain PyTorch OSBlock with the TPU kernel's numerics."""
    b, h, w, _ = x.shape
    x = x.to(torch.bfloat16)
    it = iter(flat)

    def take(n):
        return [next(it) for _ in range(n)]

    def conv1x1(z, wt):                                   # f32 accumulate
        return torch.matmul(z.float(), wt.float())

    def bn(z32, sc, sh, relu=True):
        y = z32.to(torch.bfloat16) * sc.reshape(-1) + sh.reshape(-1)
        return torch.clamp(y, min=0) if relu else y

    w1, sc1, sh1 = take(3)
    y = bn(conv1x1(x, w1), sc1, sh1)

    def lite(z):
        wp, dw, sc, sh = take(4)
        z = conv1x1(z, wp).to(torch.bfloat16)
        zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1))
        acc = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
        for t in range(9):
            dy, dx = divmod(t, 3)
            acc = acc + zp[:, dy:dy + h, dx:dx + w, :].float() * dw[t]
        return bn(acc, sc, sh)

    streams = []
    for n_lite in range(1, 5):
        z = y
        for _ in range(n_lite):
            z = lite(z)
        streams.append(z)

    gw1, gb1, gw2, gb2 = take(4)
    gated = None
    for z in streams:
        pooled = z.float().mean(dim=(1, 2))               # [B, mid]
        hid = torch.relu(pooled @ gw1 + gb1[:, 0])
        gate = torch.sigmoid(hid @ gw2 + gb2[:, 0])
        g = z.float() * gate[:, None, None, :]
        gated = g if gated is None else gated + g

    w3, sc3, sh3 = take(3)
    out = bn(conv1x1(gated.to(torch.bfloat16), w3), sc3, sh3, relu=False)
    if ch_in != features:
        wd, scd, shd = take(3)
        identity = bn(conv1x1(x, wd), scd, shd, relu=False)
    else:
        identity = x
    return torch.clamp(out + identity, min=0)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def weight_counts(ch_in: int, features: int) -> tuple[int, int]:
    """(bf16 values in frag, floats in vec) of ``pack_osblock``."""
    shapes = _shapes(ch_in, features)
    return (sum(_round16(k) * n for kind, (k, n) in shapes if kind == 'm'),
            sum(k * n for kind, (k, n) in shapes if kind != 'm'))


def smem_bytes(pix: int, mid: int, hid: int, frag_n: int = 0,
               vec_n: int = 0) -> int:
    """Shared memory of one CTA whose band holds ``pix`` pixels (the
    kernel's ``smem_layout``): planes y, za[0], za[1], zb (bf16) and the
    gated sum (f32), each ``[pix, mid]``; the pool's partial sums, which
    the output staging tiles reuse; the small vectors; and ``frag_n``
    bf16 and ``vec_n`` f32 weights when they are staged."""
    red = _round16((THREADS // (mid // 8)) * mid * 4)
    return (12 * pix * mid + max(red, WARPS * 16 * CHUNK_F * 2)
            + _round16((5 * mid + hid + THREADS) * 4) + 2 * frag_n
            + _round16(4 * vec_n))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch: ``batch`` clusters of ``cluster`` CTAs, CTA ``r`` of a
    cluster computing crop rows ``r * rows .. (r + 1) * rows - 1`` with
    ``smem`` bytes of shared memory, the weights copied into it
    (``stage_weights``) or read from device memory."""
    batch: int
    cluster: int
    rows: int
    stage_weights: bool
    smem: int

    @property
    def variant(self) -> str:
        return 'weights in shared memory' if self.stage_weights \
            else 'weights from device memory'

    @property
    def ctas(self) -> int:
        return self.batch * self.cluster

    def bands(self) -> list[range]:
        """The crop rows of each CTA of a cluster, in rank order."""
        return [range(r * self.rows, (r + 1) * self.rows)
                for r in range(self.cluster)]


def launch_plan(batch: int, h: int, w: int, cin: int, features: int,
                smem_limit: int = H100_SMEM) -> LaunchPlan:
    """The smallest cluster whose bands fit in ``smem_limit`` bytes, grown
    (up to ``MAX_CLUSTER``) until the launch has ``MIN_CTAS`` CTAs. Each
    band is a whole number of rows and of 16-pixel mma tiles. The weights
    are staged in shared memory when they fit beside the band. Raises
    ``ValueError`` for a block the kernel does not take."""
    mid, hid = block_dims(features)
    if (mid not in KERNEL_MIDS or cin % 16 or features % CHUNK_F
            or w * mid // 8 > THREADS or cin > 5 * mid):
        raise ValueError(f'osblock: no kernel for C_in={cin}, F={features}')
    fits = [c for c in (1, 2, 4, 8)
            if c <= MAX_CLUSTER and h % c == 0 and (h // c * w) % 16 == 0
            and smem_bytes(h // c * w, mid, hid) <= smem_limit]
    if not fits:
        raise ValueError(f'osblock: a {h}x{w}x{mid} block fits in no '
                         f'cluster of up to {MAX_CLUSTER} CTAs with '
                         f'{smem_limit} bytes each')
    c = fits[0]
    while batch * c < MIN_CTAS and 2 * c in fits:
        c *= 2
    pix = h // c * w
    staged = smem_bytes(pix, mid, hid, *weight_counts(cin, features))
    if staged <= smem_limit:
        return LaunchPlan(batch, c, h // c, True, staged)
    return LaunchPlan(batch, c, h // c, False, smem_bytes(pix, mid, hid))


def _frag(wt: torch.Tensor) -> torch.Tensor:
    """A [K, N] matrix as bf16 16x8 tiles [N/8][K16/16] in mma fragment
    order (K zero-padded to K16, a multiple of 16): lane ``4 g + t`` of a
    tile holds rows ``2t, 2t+1, 2t+8, 2t+9`` of column ``g``."""
    k, n = wt.shape
    k16 = _round16(k)
    padded = torch.zeros(k16, n, dtype=torch.bfloat16, device=wt.device)
    padded[:k] = wt
    # k = 16 kt + 8 half + 2 t + pair, n = 8 nt + g
    return padded.reshape(k16 // 16, 2, 4, 2, n // 8, 8) \
        .permute(4, 0, 5, 2, 1, 3).reshape(-1)


def _unfrag(buf: torch.Tensor, k: int, n: int) -> torch.Tensor:
    k16 = _round16(k)
    return buf.reshape(n // 8, k16 // 16, 8, 4, 2, 2) \
        .permute(1, 4, 3, 5, 0, 2).reshape(k16, n)[:k]


def _shapes(ch_in: int, features: int) -> list[tuple[str, tuple]]:
    """(kind, shape) of each tensor of fold_osblock's list: ``m`` a bf16
    1x1 matrix (packed into frag), ``b`` a bf16 and ``f`` an f32 tensor
    (both flattened into vec)."""
    mid, hid = block_dims(features)
    convbn = [('b', (features, 1)), ('b', (features, 1))]
    out = [('m', (ch_in, mid)), ('b', (mid, 1)), ('b', (mid, 1))]
    out += [('m', (mid, mid)), ('f', (9, mid)), ('b', (mid, 1)),
            ('b', (mid, 1))] * 10
    out += [('f', (mid, hid)), ('f', (hid, 1)), ('f', (hid, mid)),
            ('f', (mid, 1))]
    out += [('m', (mid, features))] + convbn
    if ch_in != features:
        out += [('m', (ch_in, features))] + convbn
    return out


def pack_osblock(flat: list[torch.Tensor], ch_in: int, features: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """fold_osblock's list in the kernel's layout: ``(frag, vec)``, frag
    the 1x1 matrices (w1, the ten LiteConv wp, w3, wd) as bf16 fragment
    tiles, vec every other tensor flattened in list order as f32 (the
    bf16 ones exactly). Raises ``ValueError`` on a list of another
    length or shape."""
    shapes = _shapes(ch_in, features)
    if len(flat) != len(shapes):
        raise ValueError(f'osblock: {len(flat)} weight tensors, the kernel '
                         f'takes {len(shapes)}')
    mats, vecs = [], []
    for a, (kind, shape) in zip(flat, shapes):
        if tuple(a.shape) != shape:
            raise ValueError(f'osblock: weight of shape {tuple(a.shape)}, '
                             f'expected {shape}')
        if kind == 'm':
            mats.append(_frag(a.to(torch.bfloat16)))
        else:
            vecs.append(a.reshape(-1).float())
    return torch.cat(mats), torch.cat(vecs)


def unpack_osblock(frag: torch.Tensor, vec: torch.Tensor, ch_in: int,
                   features: int) -> list[torch.Tensor]:
    """The inverse of ``pack_osblock``: fold_osblock's list again, with
    its dtypes."""
    flat, fo, vo = [], 0, 0
    for kind, (k, n) in _shapes(ch_in, features):
        if kind == 'm':
            size = _round16(k) * n
            flat.append(_unfrag(frag[fo:fo + size], k, n))
            fo += size
        else:
            a = vec[vo:vo + k * n].reshape(k, n)
            vo += k * n
            flat.append(a.to(torch.bfloat16) if kind == 'b' else a)
    return flat


@functools.cache
def _lib():
    """The built kernel library with its C signatures declared."""
    from .cuda_build import load
    lib = load('osnet_block')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.osblock_forward.argtypes = [vp, vp, vp, vp] + [ci] * 10 + [vp]
    lib.osblock_forward.restype = ci
    lib.osblock_frag_count.argtypes = [ci] * 3
    lib.osblock_frag_count.restype = ci
    lib.osblock_vec_count.argtypes = [ci] * 4
    lib.osblock_vec_count.restype = ci
    lib.osblock_smem_bytes.argtypes = [ci] * 5
    lib.osblock_smem_bytes.restype = ci
    lib.osblock_prepare.argtypes = [ci] * 3 + [ctypes.POINTER(ci)]
    lib.osblock_prepare.restype = ci
    lib.osblock_error_string.argtypes = [ci]
    lib.osblock_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _smem_limit(index: int) -> int:
    return torch.cuda.get_device_properties(index) \
        .shared_memory_per_block_optin


def _check(err: int):
    if err:
        raise RuntimeError('osblock kernel: '
                           + _lib().osblock_error_string(err).decode())


@functools.cache
def _prepared_plan(batch: int, h: int, w: int, cin: int, features: int,
                   index: int) -> LaunchPlan:
    """``launch_plan`` on card ``index``, prepared once before its first
    launch: raises unless at least one of its clusters fits on the card
    (``cudaOccupancyMaxActiveClusters``)."""
    plan = launch_plan(batch, h, w, cin, features, _smem_limit(index))
    clusters = ctypes.c_int(0)
    with torch.cuda.device(index):
        _check(_lib().osblock_prepare(block_dims(features)[0], plan.cluster,
                                      plan.smem, ctypes.byref(clusters)))
    if clusters.value < 1:
        raise RuntimeError(f'osblock kernel: no cluster of {plan.cluster} '
                           f'CTAs with {plan.smem} B of shared memory fits '
                           'on the card')
    return plan


@functools.cache
def _kernel_counts(cin: int, features: int) -> tuple[int, int]:
    """The kernel's own sizes of frag and vec (held against the packing)."""
    mid, hid = block_dims(features)
    lib = _lib()
    return (lib.osblock_frag_count(cin, features, mid),
            lib.osblock_vec_count(cin, features, mid, hid))


def osblock(x: torch.Tensor, flat: list[torch.Tensor], ch_in: int,
            features: int, packed=None) -> torch.Tensor:
    """One OSBlock: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. ``x`` is ``[B, H, W, C_in]``; on CUDA it must be a
    contiguous bf16 tensor. ``packed`` is ``pack_osblock(flat, ...)``,
    made once by the caller; without it the call packs ``flat`` itself."""
    if x.device.type == 'cpu':
        return osblock_reference(x, flat, ch_in, features)
    if x.device.type != 'cuda':
        raise ValueError(f'osblock: unsupported device {x.device}')
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.dim() != 4:
        raise ValueError('osblock: x must be a contiguous bf16 [B, H, W, C] '
                         f'tensor, got {x.dtype} {tuple(x.shape)}')
    b, h, w, c = x.shape
    if c != ch_in:
        raise ValueError(f'osblock: {c} input channels, expected {ch_in}')
    frag, vec = packed if packed is not None else \
        pack_osblock(flat, ch_in, features)
    if frag.device != x.device or vec.device != x.device:
        raise ValueError(f'osblock: weights on {frag.device}, x on '
                         f'{x.device}')
    if (frag.numel(), vec.numel()) != _kernel_counts(ch_in, features):
        raise ValueError('osblock: the packed weights do not match the '
                         "kernel's layout")
    plan = _prepared_plan(b, h, w, ch_in, features, x.device.index or 0)
    mid, hid = block_dims(features)
    out = torch.empty((b, h, w, features), dtype=torch.bfloat16,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(_lib().osblock_forward(
        x.data_ptr(), frag.data_ptr(), vec.data_ptr(), out.data_ptr(), b, h,
        w, ch_in, features, mid, hid, plan.cluster, int(plan.stage_weights),
        plan.smem, stream))
    osblock.launches += 1
    return out


osblock.launches = 0

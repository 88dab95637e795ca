"""Kalman filter functions (``fastmot_tpu_torch/kalman.py``).

Frozen copy of the plain (CPU) version in the port at the commit
that added the benchmark, with the kernel dispatch taken out; it
imports nothing of the port, so later changes to the port cannot
move the yardstick.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class MeasType(enum.Enum):
    FLOW = 0
    DETECTOR = 1


@dataclasses.dataclass(frozen=True)
class KalmanConfig:
    std_factor_acc: float = 2.25
    std_offset_acc: float = 78.5
    std_factor_det: tuple[float, float] = (0.08, 0.08)
    std_factor_klt: tuple[float, float] = (0.14, 0.14)
    min_std_det: tuple[float, float] = (4.0, 4.0)
    min_std_klt: tuple[float, float] = (5.0, 5.0)
    init_pos_weight: float = 5.0
    init_vel_weight: float = 12.0
    vel_coupling: float = 0.6
    vel_half_life: float = 2.0

    def __post_init__(self):
        assert self.std_factor_acc >= 0
        assert all(f >= 0 for f in self.std_factor_det)
        assert all(f >= 0 for f in self.std_factor_klt)
        assert all(f >= 0 for f in self.min_std_det)
        assert all(f >= 0 for f in self.min_std_klt)
        assert self.init_pos_weight >= 0
        assert self.init_vel_weight >= 0
        assert 0 <= self.vel_coupling <= 1
        assert self.vel_half_life > 0


def init_mats(cfg: KalmanConfig, dt: float):
    """(acc_cov, meas_mat, trans_mat) as float32 numpy arrays."""
    acc_cov = np.diag(np.array([0.25 * dt ** 4] * 4 + [dt ** 2] * 4,
                               dtype=np.float32))
    off = np.eye(4, dtype=np.float32) * (0.5 * dt ** 3)
    acc_cov[4:, :4] = off
    acc_cov[:4, 4:] = off
    meas_mat = np.eye(4, 8, dtype=np.float32)
    trans = np.eye(8, dtype=np.float32)
    for i in range(4):
        trans[i, i + 4] = cfg.vel_coupling * dt
        trans[i, (i + 2) % 4 + 4] = (1.0 - cfg.vel_coupling) * dt
        trans[i + 4, i + 4] = 0.5 ** (dt / cfg.vel_half_life)
    return acc_cov, meas_mat, trans


def _f32(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def create(cfg: KalmanConfig, det_tlbr: torch.Tensor):
    """State from a detection: [..., 4] -> ([..., 8], [..., 8, 8])."""
    det_tlbr = det_tlbr.to(torch.float32)
    mean = torch.cat([det_tlbr, torch.zeros_like(det_tlbr)], dim=-1)
    w = det_tlbr[..., 2] - det_tlbr[..., 0] + 1.0
    h = det_tlbr[..., 3] - det_tlbr[..., 1] + 1.0
    sf = _f32([cfg.std_factor_det[0], cfg.std_factor_det[1]] * 4, det_tlbr)
    wh = _f32([1.0, 0.0] * 4, det_tlbr) * w[..., None] + \
        _f32([0.0, 1.0] * 4, det_tlbr) * h[..., None]
    weight = _f32([cfg.init_pos_weight] * 4 + [cfg.init_vel_weight] * 4,
                  det_tlbr)
    min_std = _f32([cfg.min_std_det[0], cfg.min_std_det[1]] * 4, det_tlbr)
    std = torch.maximum(weight * sf * wh, min_std)
    cov = torch.diag_embed(std * std)
    return mean, cov


def predict(cfg: KalmanConfig, mean, cov, trans_mat, acc_cov):
    """Prediction step with size-scaled process noise."""
    w = mean[..., 2] - mean[..., 0] + 1.0
    h = mean[..., 3] - mean[..., 1] + 1.0
    std = cfg.std_factor_acc * torch.maximum(w, h) + cfg.std_offset_acc
    motion_cov = acc_cov * (std * std)[..., None, None]
    mean = mean @ trans_mat.T
    cov = trans_mat @ cov @ trans_mat.T + motion_cov
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def _meas_std(cfg: KalmanConfig, mean4, meas_type_flow, multiplier):
    """The measurement noise's std [..., 4]. ``meas_type_flow`` and
    ``multiplier`` are tensors (per track) or Python values; a Python
    value picks its constants on the host, so that no host value is
    copied to the device (a sync on the card) and the products round
    alike."""
    w = mean4[..., 2] - mean4[..., 0] + 1.0
    h = mean4[..., 3] - mean4[..., 1] + 1.0
    if isinstance(meas_type_flow, torch.Tensor):
        flow = meas_type_flow.to(mean4.device)
        sf_w = torch.where(flow, cfg.std_factor_klt[0], cfg.std_factor_det[0])
        sf_h = torch.where(flow, cfg.std_factor_klt[1], cfg.std_factor_det[1])
        mn_w = torch.where(flow, cfg.min_std_klt[0], cfg.min_std_det[0])
        mn_h = torch.where(flow, cfg.min_std_klt[1], cfg.min_std_det[1])
    else:
        klt = bool(meas_type_flow)
        sf_w, sf_h = cfg.std_factor_klt if klt else cfg.std_factor_det
        mn_w, mn_h = cfg.min_std_klt if klt else cfg.min_std_det
    sw = torch.clamp(sf_w * w, min=mn_w)
    sh = torch.clamp(sf_h * h, min=mn_h)
    std = torch.stack([sw, sh, sw, sh], dim=-1)
    if isinstance(multiplier, torch.Tensor):
        return std * multiplier.to(mean4.device, torch.float32)[..., None]
    return std * float(multiplier)


def project(cfg: KalmanConfig, mean, cov, meas_type_flow, multiplier=1.0):
    """State -> measurement space (mean [..., 4], cov [..., 4, 4])."""
    std = _meas_std(cfg, mean[..., :4], meas_type_flow, multiplier)
    return mean[..., :4], cov[..., :4, :4] + torch.diag_embed(std * std)


def update(cfg: KalmanConfig, mean, cov, measurement, meas_type_flow,
           multiplier=1.0):
    """Correction step; the gain solves the 4x4 innovation system."""
    proj_mean, proj_cov = project(cfg, mean, cov, meas_type_flow, multiplier)
    cov_ht = cov[..., :, :4]                                # [..., 8, 4]
    # the _ex variants skip the error check (a host sync on the card)
    gain = torch.linalg.solve_ex(proj_cov, cov_ht.transpose(-1, -2))[0] \
        .transpose(-1, -2)
    innovation = measurement - proj_mean
    new_mean = mean + (gain @ innovation[..., None])[..., 0]
    new_cov = cov - gain @ proj_cov @ gain.transpose(-1, -2)
    return new_mean, new_cov


def maha_distance(cfg: KalmanConfig, means, covs, measurements):
    """[T] states x [N, 4] measurements -> [T, N] squared Mahalanobis
    distance in detector space."""
    proj_mean, proj_cov = project(cfg, means, covs, False)
    diff = measurements[None, :, :] - proj_mean[:, None, :]      # [T, N, 4]
    chol = torch.linalg.cholesky_ex(proj_cov)[0]
    y = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2),
                                      upper=False)
    return torch.sum(y * y, dim=-2)


def warp(means, covs, h_mat):
    """Warp [T, 8] means / [T, 8, 8] covariances by a 3x3 homography.

    Each corner p maps to g(p) = (A p + t) / (c.p + 1) and its velocity v
    to Dg(p) v. The Jacobian of the whole 8-vector map is block-structured:
    per corner, d p2/d p = Dg(p) and d v2/d v = Dg(p), d v2/d p is the
    second derivative of g contracted with v. Written out of place, so it
    runs under ``torch.func.vmap``."""
    a = h_mat[:2, :2]
    t = h_mat[:2, 2]
    cvec = h_mat[2, :2]
    pos, vel, dgs, dv_dps = [], [], [], []
    for ps, vs in ((slice(0, 2), slice(4, 6)), (slice(2, 4), slice(6, 8))):
        p = means[:, ps]
        v = means[:, vs]
        denom = p @ cvec + 1.0                               # [T]
        num = p @ a.T + t                                    # [T, 2]
        cv = v @ cvec                                        # [T]
        d1 = denom[:, None]
        d2 = d1 * d1
        av = v @ a.T
        pos.append(num / d1)
        vel.append(av / d1 - num * cv[:, None] / d2)
        # Dg(p) = A / d - num c^T / d^2
        dgs.append(a[None] / d1[..., None] - num[:, :, None]
                   * cvec[None, None, :] / d2[..., None])
        # v2 = A v / d - num (c.v) / d^2, so d v2 / d p is
        # d/dp [A v / d]        = -(A v) c^T / d^2
        # minus
        # d/dp [num (c.v)/d^2]  = (c.v) (A / d^2 - 2 num c^T / d^3)
        d3 = d2 * d1
        dv_dps.append(-av[:, :, None] * cvec[None, None, :] / d2[..., None]
                      - cv[:, None, None] * (a[None] / d2[..., None]
                                             - 2.0 * num[:, :, None]
                                             * cvec[None, None, :]
                                             / d3[..., None]))
    z = torch.zeros_like(dgs[0])
    jac = torch.cat([torch.cat(row, -1) for row in (
        (dgs[0], z, z, z), (z, dgs[1], z, z),
        (dv_dps[0], z, dgs[0], z), (z, dv_dps[1], z, dgs[1]))], -2)
    new_covs = jac @ covs @ jac.transpose(-1, -2)
    return torch.cat(pos + vel, -1), new_covs


def warp_mean_fn(mean, h_mat):
    """Homography pushforward of one 8-dim state mean: each corner p maps
    to g(p) = (A p + t) / (c.p + 1) and its velocity v to Dg(p) v."""
    a = h_mat[:2, :2]
    t = h_mat[:2, 2]
    cvec = h_mat[2, :2]

    def push(p, v):
        denom = cvec @ p + 1.0
        num = a @ p + t
        return num / denom, (a @ v) / denom - num * (cvec @ v) / (
            denom * denom)

    tl2, vtl2 = push(mean[0:2], mean[4:6])
    br2, vbr2 = push(mean[2:4], mean[6:8])
    return torch.cat([tl2, br2, vtl2, vbr2])

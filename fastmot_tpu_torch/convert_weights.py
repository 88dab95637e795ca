"""Convert pretrained checkpoints into the JAX package's ``.npz`` weight
files, with torch only (the JAX-free twin of ``scripts/convert_weights.py``:
the same sub-commands, arguments and output files).

  * darknet: a ``.weights`` file for a registered zoo YOLO (``--model``) or
    an explicit cfg (``--cfg``), read in cfg traversal order
    (``models/darknet.load_darknet_weights``);
  * onnx: a yolo2onnx file for a darknet-backed zoo YOLO, mapped by cfg
    section ordinal (``models/onnx_import.yolo_params_from_onnx``);
  * osnet: a torchreid ``.pth`` checkpoint or a torch-exported ``.onnx``
    (``models/osnet_convert.convert_state_dict``);
  * ssd: a TF frozen graph (``models/ssd_convert.convert_frozen_graph``).

Each conversion ends in a strict reload into a freshly built registered
model (``models/registry.load_npz``). By default the file goes to
``models/registry.WEIGHTS_DIR``, where ``init_params`` finds it.

Usage:
  python -m fastmot_tpu_torch.convert_weights darknet --model YOLOv4 \\
      --weights yolov4-crowdhuman.weights
  python -m fastmot_tpu_torch.convert_weights darknet --cfg custom.cfg \\
      --weights custom.weights --out custom.npz
  python -m fastmot_tpu_torch.convert_weights onnx --model YOLOv4 \\
      --onnx yolov4_crowdhuman.onnx
  python -m fastmot_tpu_torch.convert_weights osnet \\
      --ckpt osnet_x0_25_msmt17.onnx --model OSNet025
  python -m fastmot_tpu_torch.convert_weights ssd --model SSDMobileNetV1 \\
      --pb ssd_mobilenet_v1_coco.pb
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .models import registry
from .models.darknet import DarknetModule, load_darknet_weights, parse_cfg
from .weights import save_npz


def _out(args, name):
    return Path(args.out) if args.out else \
        registry.WEIGHTS_DIR / f'{name}.npz'


def _save_flat(flat: dict, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flat)


def convert_darknet(args):
    if args.model:
        cls = registry.YOLOModel.get_model(args.model)
        build = cls.build
        out = _out(args, args.model)
    else:
        assert args.cfg, 'need --model or --cfg'
        sections = parse_cfg(Path(args.cfg).read_text())

        def build():
            return DarknetModule(sections)
        out = Path(args.out or 'darknet.npz')
    state, header = load_darknet_weights(build().layers, args.weights)
    save_npz(state, out)
    # verification: a strict reload into a fresh module covers everything
    registry.load_npz(build(), out, strict=True)
    print(f'wrote {out} (darknet header {header[:3].tolist()}, '
          f'verified strict reload)')


def convert_onnx_yolo(args):
    """yolo2onnx file -> registered zoo npz."""
    from .models.onnx_import import yolo_params_from_onnx
    cls = registry.YOLOModel.get_model(args.model)
    module = cls.build()
    if not isinstance(module, DarknetModule):
        raise SystemExit(f'{args.model} is not darknet-backed; ONNX '
                         f'ordinal mapping only applies to cfg-built models')
    out = _out(args, args.model)
    save_npz(yolo_params_from_onnx(module.layers, module, args.onnx), out)
    registry.load_npz(cls.build(), out, strict=True)
    print(f'wrote {out} (verified strict reload)')


def convert_ssd(args):
    """TF frozen graph (.pb) -> registered SSD zoo npz."""
    from .models.protoparse import graphdef_constants
    from .models.ssd_convert import convert_frozen_graph
    cls = registry.SSDModel.get_model(args.model)
    module = cls.build()
    consts = graphdef_constants(Path(args.pb).read_bytes())
    flat = convert_frozen_graph(consts, module, cls.BACKBONE)
    out = _out(args, args.model)
    _save_flat(flat, out)
    registry.load_npz(module, out, strict=True)
    print(f'wrote {out} ({len(flat)} tensors, verified strict reload)')


def convert_osnet(args):
    """torchreid checkpoint (.pth, or torch-exported .onnx) -> OSNet npz."""
    from .models.osnet_convert import convert_state_dict
    cls = registry.ReIDModel.get_model(args.model)
    if str(args.ckpt).endswith('.onnx'):
        # torch.onnx keeps state_dict keys as initializer names
        from .models.onnx_import import torch_state_dict_from_onnx
        state = torch_state_dict_from_onnx(args.ckpt)
    else:
        import torch
        ckpt = torch.load(args.ckpt, map_location='cpu', weights_only=False)
        state = ckpt.get('state_dict', ckpt)
    state = {k.replace('module.', ''): np.asarray(v)
             for k, v in state.items()}
    flat = convert_state_dict(state, channels=cls.CHANNELS)
    out = _out(args, args.model)
    _save_flat(flat, out)
    registry.load_npz(cls.build(), out, strict=True)
    print(f'wrote {out} ({len(flat)} tensors, verified strict reload)')


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest='cmd', required=True)
    pd = sub.add_parser('darknet')
    pd.add_argument('--model', help='registered zoo name, e.g. YOLOv4')
    pd.add_argument('--cfg', help='explicit darknet cfg (instead of --model)')
    pd.add_argument('--weights', required=True)
    pd.add_argument('--out')
    pd.set_defaults(fn=convert_darknet)
    po = sub.add_parser('osnet')
    po.add_argument('--ckpt', required=True,
                    help='torchreid .pth or torch-exported .onnx')
    po.add_argument('--model', default='OSNet025')
    po.add_argument('--out')
    po.set_defaults(fn=convert_osnet)
    px = sub.add_parser('onnx')
    px.add_argument('--model', required=True,
                    help='darknet-backed zoo name, e.g. YOLOv4')
    px.add_argument('--onnx', required=True)
    px.add_argument('--out')
    px.set_defaults(fn=convert_onnx_yolo)
    ps = sub.add_parser('ssd')
    ps.add_argument('--model', required=True,
                    help='SSD zoo name, e.g. SSDMobileNetV1')
    ps.add_argument('--pb', required=True, help='TF frozen inference graph')
    ps.add_argument('--out')
    ps.set_defaults(fn=convert_ssd)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == '__main__':
    main()

"""Command-line entry of the port: the same flags, config decoding, main
loop and MOT-Challenge txt output as the repository's ``app.py``, on the
PyTorch port.

    python -m fastmot_tpu_torch.app -i 'seq/img1/%06d.jpg' --mot --txt out.txt

``--device`` picks the torch device (default ``cuda``; without a card the
run raises, and ``--device cpu`` runs it on the CPU). Video I/O needs
OpenCV.
"""
from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from types import SimpleNamespace

import fastmot_tpu_torch as fastmot
from fastmot_tpu_torch.device import torch_device
from fastmot_tpu_torch.models import set_label_map
from fastmot_tpu_torch.utils import ConfigDecoder, Profiler

# txt rows are flushed in batches: the tracker replays its queued device
# results on the host only when asked, and per-frame flushes would sync
# the device every frame (identical output either way)
TXT_FLUSH_FRAMES = 30


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    group = parser.add_mutually_exclusive_group()
    required = parser.add_argument_group('required arguments')
    required.add_argument('-i', '--input-uri', metavar='URI', required=True,
                          help='URI to input stream\n'
                               '1) image sequence (e.g. %%06d.jpg)\n'
                               '2) video file (e.g. file.mp4)\n'
                               '3) MIPI CSI camera (e.g. csi://0)\n'
                               '4) USB camera (e.g. /dev/video0)\n'
                               '5) RTSP stream\n'
                               '6) HTTP stream')
    parser.add_argument('-c', '--config', metavar='FILE',
                        default=Path(__file__).parents[1] / 'cfg'
                        / 'mot.json',
                        help='path to JSON configuration file')
    parser.add_argument('-l', '--labels', metavar='FILE',
                        help='path to label names (one per line)')
    parser.add_argument('-o', '--output-uri', metavar='URI',
                        help='URI to output video file')
    parser.add_argument('-t', '--txt', metavar='FILE',
                        help='path to output MOT Challenge format results')
    parser.add_argument('-m', '--mot', action='store_true',
                        help='run multiple object tracker')
    parser.add_argument('-s', '--show', action='store_true',
                        help='show visualizations')
    parser.add_argument('--device', default='cuda',
                        help='torch device (cpu to run on the CPU)')
    group.add_argument('-q', '--quiet', action='store_true',
                       help='reduce output verbosity')
    group.add_argument('-v', '--verbose', action='store_true',
                       help='increase output verbosity')
    args = parser.parse_args(argv)
    if args.txt is not None and not args.mot:
        raise parser.error('--txt requires --mot')
    device = torch_device(args.device)

    logging.basicConfig(format='%(asctime)s [%(levelname)8s] %(message)s',
                        datefmt='%Y-%m-%d %H:%M:%S')
    logger = logging.getLogger(fastmot.__name__)
    if args.quiet:
        logger.setLevel(logging.WARNING)
    elif args.verbose:
        logger.setLevel(logging.DEBUG)
    else:
        logger.setLevel(logging.INFO)

    with open(args.config) as cfg_file:
        config = json.load(cfg_file, cls=ConfigDecoder,
                           object_hook=lambda d: SimpleNamespace(**d))
    if args.labels is not None:
        with open(args.labels) as label_file:
            set_label_map(label_file.read().splitlines())

    stream = fastmot.VideoIO(config.resize_to, args.input_uri,
                             args.output_uri, **vars(config.stream_cfg))
    mot = None
    txt = None
    if args.mot:
        draw = args.show or args.output_uri is not None
        mot = fastmot.MOT(config.resize_to, **vars(config.mot_cfg),
                          draw=draw, device=device)
        mot.reset(stream.cap_dt)
    if args.txt is not None:
        Path(args.txt).parent.mkdir(parents=True, exist_ok=True)
        txt = open(args.txt, 'w')
    if args.show:
        import cv2
        cv2.namedWindow('Video', cv2.WINDOW_AUTOSIZE)

    def flush_txt():
        for frame_id, rows in sorted(mot.flush_tracks().items()):
            for trk_id, tlbr in rows:
                tl = tlbr[:2] / config.resize_to * stream.resolution
                br = tlbr[2:] / config.resize_to * stream.resolution
                w, h = br - tl + 1
                txt.write(f'{frame_id + 1},{trk_id},'
                          f'{tl[0]:.6f},{tl[1]:.6f},{w:.6f},{h:.6f},'
                          f'-1,-1,-1\n')

    # file and image sources block rather than drop frames, so whole
    # detector-skip cycles go through MOT.step_batch (same output)
    offline = (args.mot and not stream.is_live and not args.show
               and args.output_uri is None)
    cycle = mot.detector_frame_skip if args.mot else 1

    logger.info('Starting video capture...')
    stream.start_capture()
    try:
        with Profiler('app') as prof:
            batch = []
            while True:
                frame = stream.read()
                if frame is None:
                    break
                if args.show:
                    import cv2
                    if cv2.getWindowProperty('Video', 0) < 0:
                        break
                if offline:
                    batch.append(frame)
                    if len(batch) == cycle:
                        mot.step_batch(batch)
                        batch = []
                    if txt is not None and \
                            mot.frame_count % TXT_FLUSH_FRAMES < cycle:
                        flush_txt()
                    continue
                if args.mot:
                    mot.step(frame)
                    if txt is not None and \
                            mot.frame_count % TXT_FLUSH_FRAMES == 0:
                        flush_txt()
                if args.show:
                    import cv2
                    cv2.imshow('Video', frame)
                    if cv2.waitKey(1) & 0xFF == 27:
                        break
                if args.output_uri is not None:
                    stream.write(frame)
            if offline and batch:
                mot.step_batch(batch)
    finally:
        if txt is not None:
            if args.mot:
                flush_txt()
            txt.close()
        if args.show:
            import cv2
            cv2.destroyAllWindows()
        stream.release()

    if args.mot:
        logger.info('Average FPS: %d', round(mot.frame_count / prof.duration))
        mot.print_timing_info()


if __name__ == '__main__':
    main()

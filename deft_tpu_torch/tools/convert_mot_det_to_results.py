"""Public detections (MOT ``det.txt``) -> the results json of
``--public_det --load_results``, the counterpart of
``tools/convert_mot_det_to_results.py``:

    python -m deft_tpu_torch.tools.convert_mot_det_to_results \\
        --data_dir data/mot17 --ann annotations/val_half.json

Equivalent of the reference ``src/tools/convert_mot_det_to_results.py``:
each image of the annotation json gets its sequence's ``det/det.txt`` rows
of its raw frame as detection dicts (``data/public_dets.py::public_dets``,
which ``test.py`` reads back through ``load_results``), written to
``<data_dir>/<out>`` with the image ids as keys.
"""

from __future__ import annotations

import argparse
import json
import os

from deft_tpu_torch.data.public_dets import public_dets


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="data/mot17")
    ap.add_argument("--ann", default="annotations/val_half.json")
    ap.add_argument("--out", default="annotations/public_dets.json")
    args = ap.parse_args(argv)

    dets = public_dets(os.path.join(args.data_dir, args.ann), args.data_dir)
    results = {str(image_id): items for image_id, items in dets.items()}
    out_path = os.path.join(args.data_dir, args.out)
    with open(out_path, "w") as f:
        json.dump(results, f)
    print(f"wrote {out_path}: {len(results)} images")


if __name__ == "__main__":
    main()

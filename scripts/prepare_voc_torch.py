#!/usr/bin/env python
"""Dataset bootstrap CLI of the PyTorch/CUDA port (twin of scripts/prepare_voc.py).

Downloads the PASCAL VOC 2007+2012 devkits (when network egress is available),
extracts them under --data-root, and writes the deterministic seeded k-shot
split files for every (shots, seed) combination, through the port's
unit_tpu_torch.data.voc (load_voc_split over VOC2007 and VOC2012 trainval,
kshot_sample):

  python scripts/prepare_voc_torch.py --data-root datasets [--skip-download] \
      [--shots 1 2 3 5 10] [--seeds 0]

It writes scripts/prepare_voc.py's layout, <data-root>/vocsplit/
kshot_{K}_seed{S}.json (a JSON list of image ids), byte for byte.  Neither
package's data.voc.load_kshot_split_files reads that layout (they read the
Fewshot_Detection box_{K}shot_{cls}_train.txt files in the same
<data-root>/vocsplit directory): the fine-tuning loaders return None there
and fall back to seeded sampling (kshot_sample over the same records).
Kept for parity (fault R20 of the reference).
"""

import argparse
import json
import os
import sys
import tarfile
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

VOC_URLS = [
    "http://host.robots.ox.ac.uk/pascal/VOC/voc2007/VOCtrainval_06-Nov-2007.tar",
    "http://host.robots.ox.ac.uk/pascal/VOC/voc2007/VOCtest_06-Nov-2007.tar",
    "http://host.robots.ox.ac.uk/pascal/VOC/voc2012/VOCtrainval_11-May-2012.tar",
]


def download_and_extract(url: str, dest: str):
    fname = os.path.join(dest, os.path.basename(url))
    if not os.path.exists(fname):
        print(f"downloading {url}")
        urllib.request.urlretrieve(url, fname)
    print(f"extracting {fname}")
    with tarfile.open(fname) as tar:
        tar.extractall(dest)


def write_kshot_splits(devkit_root: str, out_dir: str, shots_list, seeds):
    from unit_tpu_torch.data.voc import kshot_sample, load_voc_split

    os.makedirs(out_dir, exist_ok=True)
    records = load_voc_split(devkit_root, "2007", "trainval", None)
    records += load_voc_split(devkit_root, "2012", "trainval", None)
    all_ids = list(range(20))
    for shots in shots_list:
        for seed in seeds:
            sel = kshot_sample(records, shots, all_ids, seed)
            path = os.path.join(out_dir, f"kshot_{shots}_seed{seed}.json")
            with open(path, "w") as f:
                json.dump([r["image_id"] for r in sel], f)
            print(f"wrote {path} ({len(sel)} images)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default="datasets")
    ap.add_argument("--skip-download", action="store_true")
    ap.add_argument("--shots", type=int, nargs="+", default=[1, 2, 3, 5, 10])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()

    os.makedirs(args.data_root, exist_ok=True)
    if not args.skip_download:
        for url in VOC_URLS:
            download_and_extract(url, args.data_root)
    devkit = os.path.join(args.data_root, "VOCdevkit")
    write_kshot_splits(
        devkit, os.path.join(args.data_root, "vocsplit"), args.shots, args.seeds
    )


if __name__ == "__main__":
    main()

"""Generate the dataset blobs missing from the reference tree into a data
directory (counterpart of ``scripts/synthesize_missing_data.py``).

FashionMNIST images use the reference's real label streams
(``src/data/fashionmnist/*-labels-idx1-ubyte`` under the working
directory, the reference tree's layout) where they are there, else
synthetic labels; CIFAR-10 batches are fully synthetic.  Formats are the
real on-disk ones (``data/synthesize.py``).  The tool writes files only
and runs nothing on a device, so it takes no ``--device``.  Usage::

    python -m qbmx_torch.cli.synthesize_missing_data [dest=data]
"""

from __future__ import annotations

import sys
from pathlib import Path

from qbmx_torch.data.synthesize import read_idx1, synthesize_cifar10, synthesize_fashionmnist

REF_FASHION = Path("src/data/fashionmnist")


def main(dest="data"):
    lt = le = None
    if REF_FASHION.is_dir():
        lt = read_idx1(REF_FASHION / "train-labels-idx1-ubyte")
        le = read_idx1(REF_FASHION / "t10k-labels-idx1-ubyte")
        print(f"using reference label streams ({len(lt)} train / {len(le)} test)")
    d1 = synthesize_fashionmnist(dest, labels_train=lt, labels_test=le)
    d2 = synthesize_cifar10(dest)
    print(f"wrote {d1} and {d2}")
    return d1, d2


if __name__ == "__main__":
    main(*sys.argv[1:])

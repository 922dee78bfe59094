"""Write the two h5py-made hdf5 fixtures under tests/torch_hdf5_fixtures:

    python tests/torch_write_hdf5_fixtures.py

``h5py_default.hdf5`` (h5py's default layout: superblock 0, a symbol-table
root group whose B-tree has several levels) and ``h5py_latest.hdf5``
(``libver="latest"``: superblock 3, ``OHDR`` headers, the root group's
links in a fractal heap), each holding 300 datasets
``scene{i:04d}_00 = full((1, 4), i)`` in float32. They let a machine
without h5py check that ``vlp3d_torch.data.hdf5.read_datasets`` reads
the files h5py writes (``tests/test_torch_multiview_hdf5.py`` holds them
against h5py; ``chip_smoke.py`` against the formula). Needs h5py.
"""

import os
import sys

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_hdf5_fixtures")
COUNT = 300
LAYOUTS = {"h5py_default.hdf5": None, "h5py_latest.hdf5": "latest"}


def fixture_value(i: int) -> np.ndarray:
    """The dataset ``scene{i:04d}_00`` of each fixture."""
    return np.full((1, 4), i, np.float32)


def fixture_name(i: int) -> str:
    return f"scene{i:04d}_00"


def write(path: str, libver, count: int = COUNT) -> None:
    import h5py

    with h5py.File(path, "w", libver=libver, track_order=False) as f:
        for i in range(count):
            f.create_dataset(fixture_name(i), data=fixture_value(i),
                             track_times=False)


def main() -> int:
    os.makedirs(FIXTURES, exist_ok=True)
    for name, libver in LAYOUTS.items():
        path = os.path.join(FIXTURES, name)
        write(path, libver)
        print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Grounding evaluation of the port: its own copies of the numpy
``vlp3d/eval/box_iou.py`` and ``vlp3d/eval/grounding.py``."""

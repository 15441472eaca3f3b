"""Evaluation: KITTI-style BEV/3D/AOS average precision (the reference's
second/utils/eval.py), plus prediction -> KITTI-annotation conversion."""

from .image import load_gray, load_pgm, save_pgm
from .dataset import (FrameSequence, load_kitti_poses, save_kitti_poses,
                      ate_rmse, synthetic_sequence)

__all__ = ["load_gray", "load_pgm", "save_pgm", "FrameSequence",
           "load_kitti_poses", "save_kitti_poses", "ate_rmse",
           "synthetic_sequence"]

from .image import load_gray, load_pgm, save_pgm

__all__ = ["load_gray", "load_pgm", "save_pgm"]

from .extract import palette_extraction
from .geometry import point_triangle_distance
from .histogram import compute_rgb_histogram
from .hull import hull_simplification, outside_hull_rmse
from .tan18 import star_tetra_weights

__all__ = [
    "palette_extraction",
    "point_triangle_distance",
    "compute_rgb_histogram",
    "hull_simplification",
    "outside_hull_rmse",
    "star_tetra_weights",
]

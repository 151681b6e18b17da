from .camera import OrbitCamera
from .headless import EditingSession, fit_stylizer

__all__ = ["OrbitCamera", "EditingSession", "fit_stylizer"]

from .polynomial import Rotation, rotate

from .host import CurveSpec, PALLAS, VESTA, Point

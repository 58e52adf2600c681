from .host import FP, FQ, FieldSpec, batch_invert

from .healpy_gcnn import HealpyGCNN

__all__ = ["HealpyGCNN"]

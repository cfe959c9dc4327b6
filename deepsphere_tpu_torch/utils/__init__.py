from .activations import resolve_activation

__all__ = ["resolve_activation"]

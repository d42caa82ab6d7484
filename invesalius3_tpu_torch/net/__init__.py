"""Network helpers of the port (``download``: model weights)."""

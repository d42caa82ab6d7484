"""Network helpers of the port (``download``: model weights;
``pedal_connection``: pedal input)."""

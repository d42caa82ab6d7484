"""Network helpers of the port (``download``: model weights;
``pedal_connection``: pedal input; ``dicom_net``: the PACS client and
storage SCP; ``neuronavigation_api``: the external-process boundary;
``remote_control`` / ``remote_server``: the event-bus mirror)."""

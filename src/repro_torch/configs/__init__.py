"""Architecture configs of the ported models (see ``registry``)."""

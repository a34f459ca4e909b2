"""Runtime analysis of the port (``sanitizer``: ``Config.sanitize``)."""

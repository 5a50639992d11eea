"""DER technologies and value streams."""

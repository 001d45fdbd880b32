"""Serving (port of the reference ``serve``): the host admission plane."""

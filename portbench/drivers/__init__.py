"""Drivers of the program's public entry points, one module each; a
traffic file names its driver (``"driver"``) and gives its parameters."""

"""Problem math: losses, regularizers and the saddle-point objectives."""

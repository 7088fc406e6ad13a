"""The port's command-line programs."""

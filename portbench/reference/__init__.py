"""The plain reference: see README.md."""

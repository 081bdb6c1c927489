"""Frozen copies of the program's sound arithmetic, kept with the
benchmark so that no change to the program can move the yardstick.
Each module names the port file and the commit it was copied from."""

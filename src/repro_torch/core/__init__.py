"""The index engine: hashing, the Ludo/Othello build, and ``OutbackShard``."""

"""The character set of the benchmark's configurations, frozen.

The 37 characters of a ZINC-like SMILES corpus, the pad character (a
space) first at code 0: the order in which codes index the one-hot rows
and the logits of both configurations.
"""

CHARS = (
    " ",
    "#", "%", "(", ")", "+", "-", "/", "1", "2", "3", "4", "5", "6", "7",
    "8", "9", "=", "@", "B", "C", "F", "H", "I", "N", "O", "P", "S", "[",
    "\\", "]", "c", "l", "n", "o", "r", "s",
)

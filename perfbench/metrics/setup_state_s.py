"""Set-up seconds making what the window runs on: the configuration, the
program's import, the weights, the corpus, the training state, the data
layer and the chunk, and on several cards the world and its mesh."""

PARTS = ("config", "import_program", "weights", "corpus", "init_state", "data_and_chunk", "mesh")


def read(run):
    return run.setup_part_s(PARTS)

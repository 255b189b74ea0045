"""Tree load: seconds of the npz read and ``upload_tree`` with K3 (the
jump table and skip distances), between two synchronizations."""


def read(rec):
    return rec.load_s

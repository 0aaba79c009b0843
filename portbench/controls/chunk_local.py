"""Control that breaks "state carries across chunk boundaries": each
chunk of the call's chunk length is read alone, from nothing before it,
so a match that straddles a chunk boundary is lost."""

from portbench.reference import answers


def answer(ref, shard, device, chunk):
    return answers(ref, shard, device, chunk=chunk)

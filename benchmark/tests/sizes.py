"""Small sizes of the cells for the CPU tests: the same code paths, a
genome and references of 20 kbp, a few thousand reads, and the count's
chunk and cap cut to what a CPU test holds."""

BUILD = "build-graph.k25.ecoli-30x"
CLASSIFY = "xenome-classify.k25.pdx"

SMALL = {
    BUILD: {"config": {"genome_length": 20_000, "coverage": 10},
            "traffic": {"reads_with_n": 5},
            "argv": ["--chunk-size", "4096", "--spectrum-cap", "65536"]},
    CLASSIFY: {"config": {"graft_length": 20_000, "host_length": 20_000,
                          "segment_at": 5_000, "segment_length": 2_000,
                          "sample_reads": 3_000}},
}

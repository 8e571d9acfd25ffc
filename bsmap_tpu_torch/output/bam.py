"""`.bam` output hook: the aligner writes SAM text into the .bam-named file,
then converts in place to sorted+indexed BAM (main.cpp:466-473 +
sam2bam.sh, without shelling out to samtools)."""

from ..bamio import sam_to_bam as _sam_to_bam


def sam_to_bam(path: str) -> str:
    print("Converting SAM to BAM ...")
    out = _sam_to_bam(path)
    print("Sorting BAM ...\nIndexing BAM ...")
    return out

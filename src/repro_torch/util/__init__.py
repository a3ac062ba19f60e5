from repro_torch.util.journal import (JournalCorrupt,  # noqa: F401
                                      JournalWriter, atomic_write_bytes,
                                      atomic_write_text, read_journal)

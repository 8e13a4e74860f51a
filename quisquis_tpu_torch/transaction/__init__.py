"""Transaction orchestration: building and verifying whole QuisQuis
transactions on the host, with their range proofs proved and their
embedded proofs verified in batches on the device."""

from .transaction import (Receiver, Sender, Transaction,  # noqa: F401
                          TransactionProof, batch_create_transactions,
                          batch_verify_transactions, create_transaction,
                          create_transaction_r1cs,
                          generate_value_and_account_vector,
                          verify_transaction, verify_transaction_auto,
                          verify_transaction_r1cs)
